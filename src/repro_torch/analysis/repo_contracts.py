"""The port's declared contracts (counterpart of
``repro.analysis.repo_contracts``): the reference's eleven pins, as data.

Static five — the same grids as the reference's, on the port's
:class:`~repro_torch.sweep.ClassifierEvaluator` (grouping reads only the
specs, so the vehicle lives on the CPU):

* the Fig. 7/8 error axis, the Fig. 19 parasitic axis and the Fig. 21
  drift grid each form ONE compile group;
* ``r_hat == 0`` keeps its own (solve-free) group;
* a non-varying dynamic field stays in the template.

Trace six — the reference's "compiles once" pins, read as what the port
fixes instead of XLA programs:

* ``sweep/alpha-axis-programs-once``: the 4-point alpha axis leaves one
  programmed-codes entry and runs no ``nvcc`` after its warm-up;
* ``serve/decode-launches-fixed``: every decode step of
  :class:`~repro_torch.serve.ServeRuntime` over a ragged trace launches
  the same kernels (7·L+1 ``fused_mvm`` and L ``flash_decode`` on a
  Design-A pack on the fused route);
* ``serve/paged-decode-launches-fixed`` and
  ``serve/paged-prefill-group-launches``: the same for
  :class:`~repro_torch.serve.PagedServeRuntime` over a trace with prefix
  hits and radix evictions, and every prefill of one group key launches
  the same kernels;
* ``serve/fused-signature-per-site-class``: the fused MVM signatures
  recorded while serving equal ``hw.fused_site_classes`` of the pack's
  profile, and the decode launches stay fixed;
* ``sweep/dynamic-fields-flow-from-row``: the dynamic fields' values come
  from the point's row, never from the template.

Each serving contract takes a ``vehicle`` — ``(cfg, params, pack)`` — so
``chip_smoke.py`` holds the full-width pack to it; by default it builds
the ``qwen1.5-4b`` smoke config with weights from a seed and a Design-A
pack programmed, calibrated and put on the fused route by the port.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from repro_torch.analysis.contracts import (
    TRACE_SENTINELS,
    CompileContract,
    step_launches,
    template_leak_violations,
)

#: the contracts' vehicle seed (the reference's ``PRNGKey(0)``)
SEED = 0

_classifier_cache: Dict[str, Any] = {}
_serve_cache: Dict[str, Any] = {}


def classifier_vehicle(device: str = "cpu", seed: int = SEED):
    """The 16 -> 32 -> 8 random classifier of ``tests/test_sweep.py``'s
    shape: ``(layers, xca, xte, yte)`` from a numpy seed, cached."""
    key = f"{device}/{seed}"
    if key not in _classifier_cache:
        import numpy as np
        import torch

        rng = np.random.default_rng(seed)
        dims = (16, 32, 8)
        layers = [
            (torch.as_tensor(rng.standard_normal((dims[i], dims[i + 1]))
                             * dims[i] ** -0.5, dtype=torch.float32,
                             device=device),
             torch.zeros((dims[i + 1],), dtype=torch.float32, device=device))
            for i in range(2)]
        xca = torch.as_tensor(rng.standard_normal((64, 16)),
                              dtype=torch.float32, device=device)
        xte = torch.as_tensor(rng.standard_normal((128, 16)),
                              dtype=torch.float32, device=device)
        yte = torch.as_tensor(rng.integers(0, 8, (128,)), device=device)
        _classifier_cache[key] = (layers, xca, xte, yte)
    return _classifier_cache[key]


def _evaluator(device: str = "cpu"):
    from repro_torch.sweep import ClassifierEvaluator

    return ClassifierEvaluator(*classifier_vehicle(device), device=device)


def _sweep(axes, base=None, trials=1):
    from repro_torch.core.adc import ADCConfig
    from repro_torch.core.analog import AnalogSpec
    from repro_torch.sweep import SweepSpec

    return SweepSpec(
        name="contract",
        base=base if base is not None
        else AnalogSpec(adc=ADCConfig(style="none"), max_rows=64),
        axes=tuple(axes),
        trials=trials,
    )


def _alpha_sweep():
    from repro_torch.core import errors as E
    from repro_torch.core.adc import ADCConfig
    from repro_torch.core.analog import AnalogSpec
    from repro_torch.sweep import Axis

    return _sweep(
        (Axis("error.alpha", (0.01, 0.02, 0.05, 0.1)),),
        base=AnalogSpec(adc=ADCConfig(style="none"),
                        error=E.state_proportional(0.0)),
        trials=2)


def static_contracts() -> List[CompileContract]:
    from repro_torch.core import errors as E
    from repro_torch.core.adc import ADCConfig
    from repro_torch.core.analog import AnalogSpec
    from repro_torch.sweep import Axis

    return [
        CompileContract(
            name="sweep/alpha-axis-one-group",
            description="Fig. 7/8 error axis batches as one group",
            sweep=_alpha_sweep(),
            evaluator=_evaluator,
            max_groups=1,
            require_dynamic=("error.alpha",),
        ),
        CompileContract(
            name="sweep/constant-field-stays-static",
            description="non-varying dynamic fields stay in the template "
                        "(equal to the serial reference)",
            sweep=_sweep(
                (Axis("max_rows", (72, 1152)),),
                base=AnalogSpec(adc=ADCConfig(style="none"),
                                error=E.state_proportional(0.05))),
            evaluator=_evaluator,
            max_groups=2, min_groups=2,
            expect_dynamic=((),),
        ),
        CompileContract(
            name="sweep/r-hat-axis-one-group",
            description="Fig. 19 parasitic axis shares one group across "
                        "r_hat levels",
            sweep=_sweep((Axis("r_hat", (1e-5, 1e-4, 1e-3)),)),
            evaluator=_evaluator,
            max_groups=1,
            require_dynamic=("r_hat",),
        ),
        CompileContract(
            name="sweep/r-hat-on-off-split",
            description="r_hat == 0 keeps its own solve-free group, never "
                        "made dynamic at zero",
            sweep=_sweep((Axis("r_hat", (0.0, 1e-4, 1e-3)),)),
            evaluator=_evaluator,
            max_groups=2, min_groups=2,
            expect_dynamic=((), ("r_hat",)),
            require_dynamic=("r_hat",),
        ),
        CompileContract(
            name="sweep/drift-grid-one-group",
            description="Fig. 21 nu x t drift grid forms one group "
                        "(horizon and exponent both dynamic)",
            sweep=_sweep(
                (Axis("drift.nu", (0.1, 0.2)),
                 Axis("drift.t", (1.0, 16.0, 256.0))),
                base=AnalogSpec(adc=ADCConfig(style="none"), max_rows=64,
                                drift=E.power_law_drift(0.2))),
            evaluator=_evaluator,
            max_groups=1,
            expect_dynamic=(("drift.nu", "drift.t"),),
            require_dynamic=("drift.nu", "drift.t"),
        ),
    ]


# ---------------------------------------------------------------------------
# trace level: the sweep
# ---------------------------------------------------------------------------


def alpha_grid_contract(device: str = "cuda") -> CompileContract:
    from repro_torch.analysis.contracts import compile_counter
    from repro_torch.sweep import run_sweep

    ev = _evaluator(device)
    sweep = _alpha_sweep()

    def run():
        with compile_counter() as builds:
            run_sweep(sweep, ev)
        return ([] if builds.count == 0 else
                [f"the alpha axis ran nvcc {builds.count} times after its "
                 f"warm-up"])

    return CompileContract(
        name="sweep/alpha-axis-programs-once",
        description="running the 4-point error axis leaves exactly one "
                    "programmed-codes entry and builds no kernel after a "
                    "warm-up run on another evaluator",
        warmup=lambda: run_sweep(sweep, _evaluator(device)),
        run=run,
        entries=lambda: [ev],
        max_compiles=1,
    )


def traced_fields_contract(device: str = "cuda") -> CompileContract:
    def run():
        from repro_torch.core import errors as E
        from repro_torch.core.adc import ADCConfig
        from repro_torch.core.analog import AnalogSpec
        from repro_torch.sweep.evaluate import materialize, trial_accuracy

        layers, xca, xte, yte = classifier_vehicle(device)
        template = AnalogSpec(adc=ADCConfig(style="none"), max_rows=64,
                              error=E.state_proportional(0.05), r_hat=1e-3)

        def point(tmpl, row):
            spec = materialize(tmpl, row)
            return spec, float(trial_accuracy(layers, spec, SEED, xca, xte,
                                              yte))

        return template_leak_violations(
            point, template, {"error.alpha": 0.05, "r_hat": 1e-4},
            TRACE_SENTINELS[:2], label="classifier trial_accuracy")

    return CompileContract(
        name="sweep/dynamic-fields-flow-from-row",
        description="values of fields declared dynamic come from the "
                    "point's row, never from the template",
        run=run,
    )


# ---------------------------------------------------------------------------
# trace level: serving
# ---------------------------------------------------------------------------


def serve_vehicle(device: str = "cuda", seed: int = SEED):
    """``(cfg, params, pack)``: the ``qwen1.5-4b`` smoke config, weights
    from ``seed``, a Design-A pack (no cell error) programmed from
    ``seed + 1``, calibrated on 2 x 24 tokens and on the fused route."""
    key = f"{device}/{seed}"
    if key not in _serve_cache:
        import numpy as np

        from repro_torch.configs import get_smoke_config
        from repro_torch.core.analog import design_a
        from repro_torch.core.errors import ErrorModel
        from repro_torch.models.registry import get_model
        from repro_torch.serve import calibrate_lm, program_lm
        from repro_torch.sweep.serve_eval import pack_with_fused

        cfg = get_smoke_config("qwen1.5-4b")
        params = get_model(cfg).init_params(cfg, seed, device=device)
        rng = np.random.default_rng(seed)
        calib = rng.integers(0, cfg.vocab, size=(2, 24)).astype(np.int64)
        pack = program_lm(cfg, params, design_a(error=ErrorModel()),
                          seed=seed + 1)
        pack = calibrate_lm(cfg, params, pack, calib)
        _serve_cache[key] = (cfg, params, pack_with_fused(pack, "kernel"))
    return _serve_cache[key]


def expected_step_launches(cfg, pack, attn: str) -> Dict[str, int]:
    """The kernels one decode step launches: a fused MVM per analog site
    and layer whose spec fuses (and the head's), one ``attn`` kernel per
    layer."""
    from repro_torch.core.analog import AnalogSpec, fuse_signature
    from repro_torch.serve.analog_engine import lm_hook_names

    kinds = {"linear": "fused_mvm", "parasitic": "fused_mvm_parasitic"}
    out: Dict[str, int] = {attn: cfg.n_layers}
    specs = []
    if pack is not None:
        specs = [pack.profile.resolve(site, layer)
                 for site in lm_hook_names(cfg)
                 for layer in range(cfg.n_layers)]
        specs.append(pack.head_spec)
    for spec in specs:
        if isinstance(spec, AnalogSpec):
            sig = fuse_signature(spec)
            if sig is not None:
                out[kinds[sig[0]]] = out.get(kinds[sig[0]], 0) + 1
    return out


def dense_trace(rt, vocab: int, seed: int = SEED) -> None:
    """The reference's ragged trace: 9 requests, prompts of 3-14 tokens,
    budgets of 2-8, drawn from ``seed``; served to completion."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for i in range(9):
        prompt = rng.integers(
            0, vocab, size=int(rng.integers(3, 15))).astype(np.int32)
        rt.submit(prompt, max_new_tokens=int(rng.integers(2, 9)), uid=i)
    rt.run()


def paged_trace(rt, vocab: int, seed: int = SEED) -> None:
    """The reference's paged trace: a wave sharing a 9-token prefix on
    every other prompt, then a distinct-prefix wave that forces radix
    eviction; served to completion and checked."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=9).astype(np.int32)
    for i in range(9):
        if i % 2:
            tail = rng.integers(
                0, vocab, size=int(rng.integers(1, 5))).astype(np.int32)
            prompt = np.concatenate([shared, tail])
        else:
            prompt = rng.integers(
                0, vocab, size=int(rng.integers(3, 13))).astype(np.int32)
        rt.submit(prompt, max_new_tokens=int(rng.integers(2, 7)), uid=i)
    rt.run()
    for i in range(6):
        prompt = rng.integers(
            0, vocab, size=int(rng.integers(10, 13))).astype(np.int32)
        rt.submit(prompt, max_new_tokens=4, uid=100 + i)
    rt.run()
    rt.check()


def serve_dense(vehicle, trace_seed: int = SEED):
    """Serve :func:`dense_trace` through ``ServeRuntime(max_slots=3,
    max_len=32, attn_backend="flash")`` under :class:`step_launches`;
    returns ``(runtime, recorder, BUILD_SIGNATURES seen)``."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeRuntime

    cfg, params, pack = vehicle
    ops.BUILD_SIGNATURES.clear()
    rt = ServeRuntime(cfg, params, pack=pack, max_slots=3, max_len=32,
                      attn_backend="flash")
    with step_launches(rt) as rec:
        dense_trace(rt, cfg.vocab, trace_seed)
    return rt, rec, set(ops.BUILD_SIGNATURES)


def serve_paged(vehicle, trace_seed: int = SEED):
    """Serve :func:`paged_trace` through ``PagedServeRuntime(page_size=4,
    num_pages=14, backend="kernel")`` under :class:`step_launches`;
    returns ``(runtime, recorder)``."""
    from repro_torch.serve import PagedServeRuntime

    cfg, params, pack = vehicle
    rt = PagedServeRuntime(cfg, params, pack=pack, max_slots=3, max_len=32,
                           page_size=4, num_pages=14, backend="kernel")
    with step_launches(rt) as rec:
        paged_trace(rt, cfg.vocab, trace_seed)
    return rt, rec


def decode_launches_contract(vehicle=None,
                             device: str = "cuda") -> CompileContract:
    def run():
        v = vehicle if vehicle is not None else serve_vehicle(device)
        cfg, _, pack = v
        _, rec, _ = serve_dense(v)
        return rec.decode_violations(
            "ServeRuntime", expected_step_launches(cfg, pack, "flash_decode")
        ) + rec.prefill_violations("ServeRuntime")

    return CompileContract(
        name="serve/decode-launches-fixed",
        description="every decode step of ServeRuntime over a mixed ragged "
                    "trace launches the same kernels (raggedness lives in "
                    "data, never in what launches)",
        run=run,
    )


def paged_contracts(vehicle=None,
                    device: str = "cuda") -> Tuple[CompileContract, ...]:
    """``serve/paged-decode-launches-fixed`` and
    ``serve/paged-prefill-group-launches``, sharing one served trace."""
    state: Dict[str, Any] = {}

    def served():
        if "rec" not in state:
            v = vehicle if vehicle is not None else serve_vehicle(device)
            rt, rec = serve_paged(v)
            state.update(rt=rt, rec=rec, vehicle=v)
        return state

    def run_decode():
        s = served()
        cfg, _, pack = s["vehicle"]
        out = s["rec"].decode_violations(
            "PagedServeRuntime",
            expected_step_launches(cfg, pack, "paged_attention"))
        stats = s["rt"].stats
        if stats["prefix_hits"] <= 0:
            out.append("contract trace produced no prefix hits")
        if stats["cache_evictions"] <= 0:
            out.append("contract trace produced no radix evictions")
        return out

    def run_prefill():
        return served()["rec"].prefill_violations("PagedServeRuntime")

    return (
        CompileContract(
            name="serve/paged-decode-launches-fixed",
            description="PagedServeRuntime's decode step launches the same "
                        "kernels across a trace with prefix hits and radix "
                        "evictions (block tables are data)",
            run=run_decode,
        ),
        CompileContract(
            name="serve/paged-prefill-group-launches",
            description="every paged prefill of one group key (shared "
                        "ctx, suffix bucket, gang size) launches the same "
                        "kernels",
            run=run_prefill,
        ),
    )


def fused_signature_contract(vehicle=None,
                             device: str = "cuda") -> CompileContract:
    def run():
        from repro_torch.hw import fused_site_classes
        from repro_torch.serve.analog_engine import lm_hook_names

        v = vehicle if vehicle is not None else serve_vehicle(device)
        cfg, _, pack = v
        expected = set(fused_site_classes(
            pack.profile, lm_hook_names(cfg), cfg.n_layers))
        _, rec, built = serve_dense(v)
        out = []
        if built != expected:
            out.append(
                f"fused-kernel signatures diverge from the profile's site "
                f"classes: launched {sorted(built, key=repr)}, "
                f"hw.fused_site_classes predicts "
                f"{sorted(expected, key=repr)}")
        out.extend(rec.decode_violations(
            "fused decode", expected_step_launches(cfg, pack,
                                                   "flash_decode")))
        return out

    return CompileContract(
        name="serve/fused-signature-per-site-class",
        description="serving through the fused kernels launches exactly "
                    "one kernel signature per distinct site class "
                    "(hw.fused_site_classes), and the fused decode step "
                    "still launches the same kernels every step",
        run=run,
    )


def trace_contracts(device: str = "cuda",
                    vehicle: Optional[Tuple] = None) -> List[CompileContract]:
    return [
        alpha_grid_contract(device),
        decode_launches_contract(vehicle, device),
        *paged_contracts(vehicle, device),
        fused_signature_contract(vehicle, device),
        traced_fields_contract(device),
    ]


def all_contracts(level: str, device: str = "cuda") -> List[CompileContract]:
    if level == "static":
        return static_contracts()
    if level == "trace":
        return trace_contracts(device)
    raise ValueError(f"level must be 'static' or 'trace', got {level!r}")
