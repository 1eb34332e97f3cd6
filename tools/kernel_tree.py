"""What the kernel tools (``tools/*_bench.py``, ``tools/*_phases.py``)
share: importing the port from another checkout, and building a changed
copy of one kernel source.

Two checkouts are compared on one card by unpacking one into a git-ignored
directory and running a tool once with ``--tree`` pointing there and once
without; :func:`use_tree` makes ``import repro_torch`` load that tree's
package while ``chip_smoke`` and the tools come from this checkout.  A
variant of a kernel (one ``constexpr int`` changed, or counters inserted
at fixed lines) is written beside copies of the shared headers and built
from there by the package's own ``kernels.build``.
"""

from __future__ import annotations

import re
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def use_tree(tree) -> None:
    """Import ``repro_torch`` from the checkout at ``tree``, and
    ``chip_smoke`` and the tools from this one."""
    sys.path[:0] = [str(Path(tree).resolve() / "src"), str(HERE),
                    str(HERE / "tools")]


def set_constants(src: str, sets, name: str) -> str:
    """``src`` with each ``NAME=VALUE`` of ``sets`` applied to the one
    ``constexpr int NAME`` it defines; ``name`` is the file, for errors."""
    for item in sets:
        const, value = item.split("=", 1)
        src, n = re.subn(rf"(constexpr int {const} = )[^;]+;",
                         rf"\g<1>{value};", src)
        if n != 1:
            raise SystemExit(f"--set: no constexpr int {const} in {name}")
    return src


def patch(src: str, edits, name: str) -> str:
    """``src`` with each ``(text, replacement)`` of ``edits`` applied in
    turn; each text must occur exactly once, so a tool fails rather than
    instrument a source that moved on."""
    for text, repl in edits:
        if src.count(text) != 1:
            raise RuntimeError(f"{name} no longer has one {text!r}")
        src = src.replace(text, repl)
    return src


def build_copy(build, name: str, src: str, out: Path) -> None:
    """Write ``src`` as ``out/<name>.cu`` beside copies of the package's
    ``csrc/*.cuh`` headers and point ``build`` (``repro_torch.kernels.build``)
    at ``out``, so its next ``build_all`` and ``load`` use the copy."""
    out.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, out)
    (out / f"{name}.cu").write_text(src)
    build.CSRC = out
