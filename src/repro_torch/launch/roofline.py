"""Roofline analysis over the dry-run results (counterpart of
``repro.launch.roofline``), for a :class:`Hardware` passed in.

Per (arch x shape x mesh) cell, from the dry-run's per-device counts
(``launch.dryrun``, ``launch.op_stats``):

    compute term    = flops_per_device / peak_flops
    memory term     = analytic per-device HBM bytes / hbm_bw
    collective term = collective wire bytes per device / link_bw

plus MODEL_FLOPS (6ND train / 2ND forward) and the useful-compute ratio
MODEL_FLOPS / (flops_per_device * n_devices); the formulas are the
reference's.

The default hardware is :data:`H100`, the NVIDIA H100 80GB HBM3 SXM
data-sheet rates at its 700 W limit: 989e12 dense bf16 flop/s, 3.35e12
B/s of HBM, and a link of 50e9 B/s, one 400 Gb/s NDR port per GPU, the
link every 16-wide mesh axis crosses between hosts of eight GPUs.
Within a host NVLink gives 450e9 B/s each way; a mesh axis of 8 or
fewer GPUs on one host would use that rate instead.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import List, Optional

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.dryrun import RESULTS_DIR


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Peak rates of one device: ``peak_flops`` (flop/s), ``hbm_bw`` and
    ``link_bw`` (bytes/s)."""

    peak_flops: float
    hbm_bw: float
    link_bw: float


#: NVIDIA H100 80GB HBM3 SXM, 700 W: dense bf16, HBM3, one NDR port
H100 = Hardware(peak_flops=989e12, hbm_bw=3.35e12, link_bw=50e9)


def model_flops(rec: dict) -> float:
    n = rec["active_params"]
    tokens = rec["global_batch"] * (
        rec["seq_len"] if rec["kind"] != "decode" else 1)
    if rec["kind"] == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens


def analytic_memory_bytes(rec: dict) -> float:
    """The reference's analytic per-device HBM traffic model.

    The counted byte total (kept as a diagnostic) is an upper bound:
    eager execution fuses nothing, as the reference's CPU-backend HLO
    fuses less than its target does.  The roofline memory term therefore
    uses the standard analytic accounting:

      train:   3 passes over bf16 weights per microbatch (fwd, bwd, remat
               refwd) + 24 B/param optimizer traffic + 8 B/param gradient
               accumulation per microbatch + ~20*d bytes/token/layer
               activation traffic (x2 for bwd).
      prefill: 1 weight pass + activations + KV-chunk rereads of streaming
               attention (S/1024 passes over the KV written).
      decode:  1 weight pass + full cache read.
    """
    n_dev = rec["n_devices"]
    n = rec["params"]
    layers = rec.get("n_layers", 0) or 1
    d = rec.get("d_model", 0) or 1
    tokens = rec["global_batch"] * (
        rec["seq_len"] if rec["kind"] != "decode" else 1)
    act = 20.0 * d * 2.0 * tokens * layers
    kv_bytes = rec.get("kv_cache_bytes", 0.0)
    if rec["kind"] == "train":
        mb = rec.get("microbatches") or 1
        b = (3.0 * mb * 2.0 * n) + 24.0 * n + 8.0 * n * mb + 2.0 * act
    elif rec["kind"] == "prefill":
        rereads = max(rec["seq_len"] / 1024.0, 1.0)
        b = 2.0 * n + act + rereads * kv_bytes
    else:
        b = 2.0 * min(n, rec["active_params"] * rec["global_batch"]) \
            + kv_bytes + act
    return b / n_dev


def roofline_row(rec: dict, hw: Hardware = H100) -> Optional[dict]:
    if "error" in rec or "skipped" in rec:
        return None
    t_c = rec["flops_per_device"] / hw.peak_flops
    t_m = analytic_memory_bytes(rec) / hw.hbm_bw
    t_m_hlo = rec["hbm_bytes_per_device"] / hw.hbm_bw
    t_x = rec["total_collective_bytes"] / hw.link_bw
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec)
    hlo_global = rec["flops_per_device"] * rec["n_devices"]
    bound = max(t_c, t_m, t_x)
    # fraction of roofline: time the dominant resource is busy doing useful
    # model math, vs the bound implied by all three terms
    useful = mf / max(hlo_global, 1.0)
    mfu_bound = (mf / rec["n_devices"] / hw.peak_flops) / max(bound, 1e-12)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "kind": rec["kind"], "variant": rec.get("variant", "baseline"),
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "memory_hlo_s": t_m_hlo,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_global": hlo_global,
        "useful_ratio": useful,
        "roofline_fraction": mfu_bound,
    }


def _enrich(rec: dict) -> dict:
    """Attach config-derived fields needed by the analytic memory model
    (a record of no known arch is returned as it is)."""
    if rec.get("arch") not in ARCH_IDS:
        return rec
    cfg = get_config(rec["arch"])
    rec["n_layers"] = cfg.n_layers + cfg.n_enc_layers
    rec["d_model"] = cfg.d_model
    b, s = rec.get("global_batch", 1), rec.get("seq_len", 1)
    dt = 2.0
    if cfg.rwkv:
        hd = cfg.d_model // cfg.n_heads
        kv = cfg.n_layers * b * cfg.n_heads * hd * hd * 4.0
    elif cfg.ssm_state:
        apps = max(1, cfg.n_layers // max(cfg.attn_every, 1))
        kv = (apps * b * s * cfg.n_kv_heads * cfg.hd * dt * 2.0
              + cfg.n_layers * b * cfg.ssm_heads * cfg.ssm_state
              * cfg.ssm_head_dim * 4.0)
    else:
        kv = cfg.n_layers * b * s * cfg.n_kv_heads * cfg.hd * dt * 2.0
        if cfg.family == "audio":
            kv += cfg.n_layers * b * cfg.cross_kv_len * cfg.n_kv_heads \
                * cfg.hd * dt * 2.0
    rec["kv_cache_bytes"] = kv
    return rec


def load_all(results_dir: str = RESULTS_DIR,
             hw: Hardware = H100) -> List[dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(f) as fh:
            rec = _enrich(json.load(fh))
        row = roofline_row(rec, hw)
        if row is not None:
            rows.append(row)
    return rows


def format_table(rows: List[dict], mesh: str = "pod16x16") -> str:
    hdr = (f"{'arch':<22}{'shape':<13}{'comp(s)':>10}{'mem(s)':>10}"
           f"{'coll(s)':>10}{'dom':>6}{'useful':>8}{'roofl%':>8}")
    out = [hdr, "-" * len(hdr)]
    for r in rows:
        if r["mesh"] != mesh or r.get("variant", "baseline") != "baseline":
            continue
        out.append(
            f"{r['arch']:<22}{r['shape']:<13}{r['compute_s']:>10.2e}"
            f"{r['memory_s']:>10.2e}{r['collective_s']:>10.2e}"
            f"{r['dominant'][:4]:>6}{r['useful_ratio']:>8.2f}"
            f"{100*r['roofline_fraction']:>7.1f}%")
    return "\n".join(out)


def main():
    rows = load_all()
    print(format_table(rows, "pod16x16"))
    print()
    print(format_table(rows, "pod2x16x16"))


if __name__ == "__main__":
    main()
