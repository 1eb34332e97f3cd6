"""The port's lint passes (counterpart of ``repro.analysis.rules``).

Each rule is a function over a parsed :class:`~repro_torch.analysis.
walker.Module` returning :class:`~repro_torch.analysis.findings.Finding`
rows, and each answers a rule of the reference:

``bare-assert``, ``silent-except``
    The reference's guard-hygiene rules, unchanged: ``assert`` in library
    code (stripped under ``python -O``), and a broad ``except`` whose body
    is only ``pass``.

``rng-global`` (the reference's ``prng-reuse``)
    A draw from torch's global generator in library code:
    ``torch.rand/randn/randint/...`` or ``Tensor.uniform_/normal_/...``
    without ``generator=``.  Hidden global state is how trial
    independence silently breaks: two design points drawing from it are
    correlated by call order, not by their seeds.

``rng-seed`` (the reference's ``prng-seed``)
    A literal integer seed in library code (``torch.manual_seed(0)``,
    ``Generator(...).manual_seed(0)``, ``core.errors.generator(0, ...)``,
    ``np.random.default_rng(0)``): seeds are threaded parameters.  A seed
    under ``device="meta"`` draws nothing and is exempt (the reference
    exempts keys built under ``jax.eval_shape``).

``host-sync`` (the reference's ``host-sync``)
    ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``, ``float()`` /
    ``int()`` / ``bool()`` of a tensor, ``np.asarray`` / ``np.array`` or
    ``torch.cuda.synchronize()`` reachable (same-module call graph) from a
    hot root: the port's counterparts of the reference's jitted bodies,
    named in :data:`HOT_ROOTS`, and any ``def`` marked ``# repro: hot``.
    A sync there stalls the host until the card drains, once a step.

``scalar-div`` (queue C's division rule; XLA has no such hazard)
    ``/`` or ``torch.div`` of a tensor by a Python number.  PyTorch's CUDA
    kernels multiply by the number's rounded reciprocal, its CPU kernels
    divide: one ulp apart, and which one the reference's compiled program
    computes depends on the site (XLA itself rewrites a division by a
    constant into a multiply by its float32 reciprocal).  The left operand
    counts as a tensor on local evidence only (a parameter annotated
    ``torch.Tensor``, a name bound from a ``torch.*`` call or a tensor
    method); the right as a number if it is a literal, a ``float()`` /
    ``int()`` / ``len()`` / ``math.*`` result, a shape, a name bound from
    those or annotated ``int``/``float``, or a field declared ``int`` /
    ``float`` of a parameter's annotated class, in this module or the port
    (``sampler.temperature``, ``cfg.top_k``).  A constant power of two is
    exempt: its reciprocal is exact.

``tf32-toggle`` (the reference's ``Precision.HIGHEST`` pins)
    Turning TF32 on: an assignment to
    ``torch.backends.cuda.matmul.allow_tf32`` or
    ``torch.backends.cudnn.allow_tf32`` other than ``False``, or
    ``torch.set_float32_matmul_precision`` other than ``"highest"``.

``csrc-rounding`` lives in :mod:`repro_torch.analysis.csrc`: the C++
sources are not Python, so this AST layer cannot read them.
"""

from __future__ import annotations

import ast
import math
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.walker import Module, rule

#: the port's counterparts of the reference's jitted bodies, by module
#: path (relative to ``src/``) -> ``Class.method`` or function names.
#: ``tests/test_torch_analysis.py`` holds every entry to a ``def`` of the
#: port, so a rename fails a test instead of shrinking the rule.
#: (``repro/sweep/evaluate.py:361``, ``FunctionEvaluator``'s vmapped
#: lambda, traces the caller's ``fn``, which no module of the port owns.)
HOT_ROOTS: Dict[str, tuple] = {
    # repro/serve/runtime.py:315 (decode), :588 (prefill)
    "repro_torch/serve/runtime.py": ("ServeRuntime._run_decode",
                                     "ServeRuntime._prefill"),
    # repro/serve/paged.py:267 (paged prefill) and the decode model half
    "repro_torch/serve/paged.py": ("PagedServeRuntime._paged_prefill",
                                   "PagedServeRuntime._decode_model"),
    # repro/serve/health.py:177 (the jitted probe)
    "repro_torch/serve/health.py": ("PackManager._probe",),
    # repro/sweep/evaluate.py:290 (ClassifierEvaluator's point function)
    "repro_torch/sweep/evaluate.py": ("trial_accuracy",),
    # repro/sweep/serve_eval.py:228 (ServeEvaluator's point function)
    "repro_torch/sweep/serve_eval.py": ("_serve_point",),
    # repro/launch/steps.py:74, :101, :127 (the jitted sharded steps)
    "repro_torch/launch/steps.py": ("build_train_step.fn",
                                    "build_prefill.fn", "build_decode.fn"),
}

#: the inline marker naming an extra hot root on a ``def`` line
HOT_MARKER = "# repro: hot"

_RNG_FNS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
            "multinomial", "poisson", "rand_like", "randn_like",
            "randint_like"}
_RNG_METHODS = {"uniform_", "normal_", "bernoulli_", "exponential_",
                "random_", "geometric_", "log_normal_", "cauchy_"}

_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
_SYNC_FNS = {"numpy.asarray": "np.asarray", "numpy.array": "np.array"}
_SYNC_CASTS = {"float", "int", "bool"}

#: ``torch.*`` callables that return no tensor
_TORCH_NON_TENSOR = {"device", "Generator", "Size", "dtype", "finfo",
                     "iinfo", "no_grad", "is_tensor", "get_default_dtype",
                     "manual_seed", "set_float32_matmul_precision",
                     "is_floating_point", "numel", "inference_mode",
                     "enable_grad", "set_grad_enabled"}
_TORCH_NON_TENSOR_NS = {"cuda", "backends", "distributed", "profiler",
                        "autograd", "jit", "testing", "library", "utils",
                        "fx", "func", "compiler", "_C"}
#: tensor methods whose result is a tensor, whatever the receiver's
#: evidence (numpy arrays have none of these)
_TENSOR_METHODS = {"to", "float", "double", "half", "bfloat16",
                   "contiguous", "detach", "clone", "reshape", "view",
                   "amax", "amin", "clamp", "clamp_min", "clamp_max",
                   "rsqrt", "square", "unsqueeze", "expand", "permute",
                   "transpose", "softmax", "log_softmax", "masked_fill",
                   "repeat_interleave", "index_select", "new_zeros",
                   "new_full", "new_ones", "type_as", "expand_as"}
#: methods of a tensor that return a Python value
_NON_TENSOR_METHODS = {"item", "tolist", "numel", "dim", "size",
                       "element_size", "data_ptr", "is_contiguous",
                       "stride", "nelement", "numpy", "ndimension",
                       "get_device"}
_INT_ATTRS = {"ndim", "shape"}


# ---------------------------------------------------------------------------
# local evidence: which expressions are tensors, which Python numbers
# ---------------------------------------------------------------------------


def _annotation_names(mod: Module, ann: Optional[ast.AST]) -> Set[str]:
    out: Set[str] = set()
    if ann is None:
        return out
    for n in ast.walk(ann):
        if isinstance(n, (ast.Name, ast.Attribute)):
            d = mod.dotted_name(n)
            if d:
                out.add(d)
    return out


class Evidence:
    """Tensor- and number-typed names of one scope (a ``def`` or the
    module), from its annotations and assignments, to a fixpoint."""

    def __init__(self, mod: Module, scope: ast.AST):
        self.mod = mod
        self.tensors: Set[str] = set()
        self.numbers: Set[str] = set()
        self.classes: Dict[str, Set[str]] = {}
        args = getattr(scope, "args", None)
        if isinstance(args, ast.arguments):
            for a in args.posonlyargs + args.args + args.kwonlyargs:
                names = _annotation_names(mod, a.annotation)
                if "torch.Tensor" in names:
                    self.tensors.add(a.arg)
                elif names & {"int", "float"}:
                    self.numbers.add(a.arg)
                elif names:
                    self.classes[a.arg] = names
        pairs = []
        for node in _own_nodes(scope):
            if isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name):
                names = _annotation_names(mod, node.annotation)
                if "torch.Tensor" in names:
                    self.tensors.add(node.target.id)
                elif names & {"int", "float"}:
                    self.numbers.add(node.target.id)
                elif node.value is not None:
                    pairs.append((node.target, node.value))
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, (ast.Tuple, ast.List)) \
                            and _is_shape(node.value):
                        self.numbers.update(
                            e.id for e in tgt.elts if isinstance(e, ast.Name))
                    elif (isinstance(tgt, (ast.Tuple, ast.List))
                            and isinstance(node.value, (ast.Tuple, ast.List))
                            and len(tgt.elts) == len(node.value.elts)):
                        pairs.extend(zip(tgt.elts, node.value.elts))
                    else:
                        pairs.append((tgt, node.value))
        changed = True
        while changed:
            changed = False
            for tgt, value in pairs:
                if not isinstance(tgt, ast.Name):
                    continue
                if tgt.id not in self.tensors and self.is_tensor(value):
                    self.tensors.add(tgt.id)
                    changed = True
                elif (tgt.id not in self.numbers
                      and tgt.id not in self.tensors
                      and self.is_number(value)):
                    self.numbers.add(tgt.id)
                    changed = True

    def is_tensor(self, node: ast.AST) -> bool:
        mod = self.mod
        if isinstance(node, ast.Name):
            return node.id in self.tensors
        if isinstance(node, ast.Call):
            name = mod.call_name(node)
            if name and name.startswith("torch."):
                parts = name.split(".")
                if parts[1] in _TORCH_NON_TENSOR_NS \
                        or parts[-1] in _TORCH_NON_TENSOR:
                    return False
                return True
            f = node.func
            if isinstance(f, ast.Attribute):
                if f.attr in _NON_TENSOR_METHODS:
                    return False
                return f.attr in _TENSOR_METHODS or self.is_tensor(f.value)
            return False
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.Attribute):
            return node.attr in ("T", "mT", "real", "imag") \
                and self.is_tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand)
        if isinstance(node, ast.IfExp):
            return self.is_tensor(node.body) or self.is_tensor(node.orelse)
        return False

    def is_number(self, node: ast.AST) -> bool:
        """A Python int or float, on local evidence."""
        if isinstance(node, ast.Constant):
            return isinstance(node.value, (int, float)) \
                and not isinstance(node.value, bool)
        if isinstance(node, ast.Name):
            return node.id in self.numbers
        if isinstance(node, ast.Call):
            name = self.mod.call_name(node)
            if name in ("float", "int", "len") or (
                    name is not None and name.startswith("math.")):
                return True
            f = node.func
            return isinstance(f, ast.Attribute) \
                and f.attr in ("size", "numel", "dim", "item") \
                and not node.args[1:]
        if isinstance(node, ast.Attribute):
            if node.attr in _INT_ATTRS:
                return node.attr == "ndim"
            base = node.value
            return isinstance(base, ast.Name) and any(
                node.attr in _numeric_class_fields(self.mod, c)
                for c in self.classes.get(base.id, ()))
        if isinstance(node, ast.Subscript):
            v = node.value
            return isinstance(v, ast.Attribute) and v.attr == "shape"
        if isinstance(node, ast.BinOp):
            return self.is_number(node.left) and self.is_number(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_number(node.operand)
        return False


def _own_nodes(scope: ast.AST) -> Iterable[ast.AST]:
    """Every node of ``scope`` outside its nested defs and classes."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _is_shape(node: ast.AST) -> bool:
    """``x.shape`` or ``x.size()``: a tuple of Python ints."""
    if isinstance(node, ast.Attribute):
        return node.attr == "shape"
    return isinstance(node, ast.Call) and not node.args \
        and isinstance(node.func, ast.Attribute) and node.func.attr == "size"


_SRC = Path(__file__).resolve().parents[2]
_FIELDS: Dict[str, Set[str]] = {}


def _class_fields(tree: ast.AST, name: str) -> Set[str]:
    out: Set[str] = set()
    for cls in ast.walk(tree):
        if isinstance(cls, ast.ClassDef) and cls.name == name:
            for st in cls.body:
                if isinstance(st, ast.AnnAssign) \
                        and isinstance(st.target, ast.Name) \
                        and isinstance(st.annotation, ast.Name) \
                        and st.annotation.id in ("int", "float"):
                    out.add(st.target.id)
    return out


def _numeric_class_fields(mod: Module, dotted: str) -> Set[str]:
    """Fields a class declares ``int`` or ``float``: a class of this
    module (``SamplerConfig.temperature``) or of a module of the port
    (``repro_torch.config.ModelConfig.top_k``), read from its source."""
    if "." not in dotted:
        return _class_fields(mod.tree, dotted)
    if dotted in _FIELDS:
        return _FIELDS[dotted]
    modname, cls = dotted.rsplit(".", 1)
    out: Set[str] = set()
    if modname.split(".")[0] == "repro_torch":
        base = _SRC.joinpath(*modname.split("."))
        for path in (base.with_suffix(".py"), base / "__init__.py"):
            if path.is_file():
                try:
                    out = _class_fields(ast.parse(path.read_text()), cls)
                except SyntaxError:
                    out = set()
                break
    _FIELDS[dotted] = out
    return out


def _evidence(mod: Module, node: ast.AST, cache: Dict) -> Evidence:
    scope = mod.enclosing_function(node) or mod.tree
    ev = cache.get(id(scope))
    if ev is None:
        ev = cache[id(scope)] = Evidence(mod, scope)
    return ev


def _constant(node: ast.AST) -> Optional[float]:
    """The value of a constant expression: literals folded through
    arithmetic and ``float()``/``int()``."""
    if isinstance(node, ast.Constant):
        v = node.value
        return v if isinstance(v, (int, float)) \
            and not isinstance(v, bool) else None
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _constant(node.operand)
        return None if v is None else -v
    if isinstance(node, ast.BinOp):
        a, b = _constant(node.left), _constant(node.right)
        if a is None or b is None:
            return None
        ops = {ast.Add: lambda: a + b, ast.Sub: lambda: a - b,
               ast.Mult: lambda: a * b, ast.Div: lambda: a / b,
               ast.Pow: lambda: a ** b, ast.LShift: lambda: int(a) << int(b)}
        fn = ops.get(type(node.op))
        try:
            return None if fn is None else fn()
        except (ArithmeticError, ValueError, TypeError):
            return None
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("float", "int") and len(node.args) == 1:
        return _constant(node.args[0])
    return None


def _power_of_two(node: ast.AST) -> bool:
    """A constant power of two (its reciprocal is exact)."""
    v = _constant(node)
    if v is None or v == 0 or not math.isfinite(v):
        return False
    m, _ = math.frexp(abs(float(v)))
    return m == 0.5


# ---------------------------------------------------------------------------
# (a) RNG hygiene
# ---------------------------------------------------------------------------


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


@rule("rng-global")
def check_rng_global(mod: Module) -> List[Finding]:
    out = []
    for call in mod.walk_calls():
        name = mod.call_name(call)
        site = None
        if name is not None and name.startswith("torch.") \
                and name.count(".") == 1 and name[6:] in _RNG_FNS:
            site = name
        elif isinstance(call.func, ast.Attribute) \
                and call.func.attr in _RNG_METHODS:
            site = f"Tensor.{call.func.attr}"
        if site is None or _has_kw(call, "generator"):
            continue
        out.append(Finding(
            "rng-global", mod.path, call.lineno,
            f"{site} draws from torch's global generator — hidden state "
            f"that correlates draws by call order, not by seed; pass "
            f"generator= (core.errors.generator(seed, device))"))
    return out


def _meta_device(mod: Module, call: ast.Call) -> bool:
    """The call, an enclosing call, or a ``Generator(...)`` receiver is
    on ``device="meta"``."""
    nodes = [call]
    if isinstance(call.func, ast.Attribute) \
            and isinstance(call.func.value, ast.Call):
        nodes.append(call.func.value)
    cur = mod.parents.get(call)
    while cur is not None:
        if isinstance(cur, ast.Call):
            nodes.append(cur)
        cur = mod.parents.get(cur)
    for n in nodes:
        for kw in n.keywords:
            if kw.arg == "device" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value == "meta":
                return True
    return False


def _literal_int(node: Optional[ast.AST]) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    return None


@rule("rng-seed")
def check_rng_seed(mod: Module) -> List[Finding]:
    out = []
    for call in mod.walk_calls():
        name = mod.call_name(call) or ""
        first = call.args[0] if call.args else None
        if name in ("torch.manual_seed", "numpy.random.default_rng",
                    "numpy.random.seed") \
                or name.endswith("core.errors.generator") \
                or (isinstance(call.func, ast.Attribute)
                    and call.func.attr == "manual_seed"):
            seed = _literal_int(first)
            if seed is None and name.endswith("core.errors.generator"):
                seed = next((_literal_int(kw.value) for kw in call.keywords
                             if kw.arg == "seed"), None)
        else:
            continue
        if seed is None or _meta_device(mod, call):
            continue
        what = name.rsplit(".", 1)[-1] if name else "manual_seed"
        out.append(Finding(
            "rng-seed", mod.path, call.lineno,
            f"literal integer seed {what}({seed}) in library code — thread "
            f"a seed parameter instead (pinned seeds belong in tests and "
            f"benchmarks)"))
    return out


# ---------------------------------------------------------------------------
# (b) host syncs reachable from the hot roots
# ---------------------------------------------------------------------------


def _qualname(mod: Module, node: ast.AST) -> str:
    parts = [getattr(node, "name", "<lambda>")]
    cur = mod.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.ClassDef, ast.FunctionDef,
                            ast.AsyncFunctionDef)):
            parts.append(cur.name)
        cur = mod.parents.get(cur)
    return ".".join(reversed(parts))


def module_key(path: str) -> Optional[str]:
    """``repro_torch/...`` tail of a source path, the key of
    :data:`HOT_ROOTS` (None outside the package)."""
    norm = path.replace("\\", "/")
    i = norm.rfind("repro_torch/")
    return norm[i:] if i >= 0 else None


def hot_roots(mod: Module) -> List[ast.AST]:
    """The module's hot roots: :data:`HOT_ROOTS` entries and ``def``
    lines marked ``# repro: hot``."""
    wanted = set(HOT_ROOTS.get(module_key(mod.path) or "", ()))
    roots = []
    for info in mod.functions:
        node = info.node
        if isinstance(node, ast.Lambda):
            continue
        marked = 1 <= node.lineno <= len(mod.lines) \
            and HOT_MARKER in mod.lines[node.lineno - 1]
        if marked or _qualname(mod, node) in wanted:
            roots.append(node)
    return roots


def _reachable(mod: Module, roots: List[ast.AST]) -> List[ast.AST]:
    """Same-module call-graph closure over bare-name and self.* calls
    (the reference's walk)."""
    seen: List[ast.AST] = []
    frontier = list(roots)
    while frontier:
        fn = frontier.pop()
        if any(fn is s for s in seen):
            continue
        seen.append(fn)
        for call in mod.walk_calls(fn):
            f = call.func
            name = (f.id if isinstance(f, ast.Name)
                    else f.attr if isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name) and f.value.id == "self"
                    else None)
            if name:
                frontier.extend(i.node for i in mod.by_name.get(name, []))
    return seen


@rule("host-sync")
def check_host_sync(mod: Module) -> List[Finding]:
    out = []
    flagged = set()
    cache: Dict = {}
    for fn in _reachable(mod, hot_roots(mod)):
        fn_name = getattr(fn, "name", "<lambda>")
        for call in mod.walk_calls(fn):
            site = None
            name = mod.call_name(call)
            f = call.func
            if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS \
                    and not call.args and not call.keywords:
                site = f".{f.attr}()"
            elif name == "torch.cuda.synchronize":
                site = "torch.cuda.synchronize()"
            elif name in _SYNC_FNS and call.args \
                    and not isinstance(call.args[0], ast.Constant):
                site = _SYNC_FNS[name]
            elif name in _SYNC_CASTS and len(call.args) == 1 \
                    and _evidence(mod, call, cache).is_tensor(call.args[0]):
                site = f"{name}()"
            if site and (call.lineno, site) not in flagged:
                flagged.add((call.lineno, site))
                out.append(Finding(
                    "host-sync", mod.path, call.lineno,
                    f"{site} inside {fn_name!r}, reachable from a hot root "
                    f"(a decode, prefill, probe or sweep-point body) — the "
                    f"host waits for the card there on every call"))
    return out


# ---------------------------------------------------------------------------
# (c) a tensor divided by a Python number
# ---------------------------------------------------------------------------


def _div_finding(mod: Module, node: ast.AST, left: ast.AST, right: ast.AST,
                 cache: Dict) -> Optional[Finding]:
    ev = _evidence(mod, node, cache)
    if not ev.is_tensor(left) or ev.is_tensor(right) \
            or not ev.is_number(right) or _power_of_two(right):
        return None
    return Finding(
        "scalar-div", mod.path, node.lineno,
        f"tensor divided by the Python number {ast.unparse(right)!r}: "
        f"CUDA multiplies by its rounded reciprocal, the CPU divides — "
        f"pick the form the reference's compiled program computes "
        f"(core.quant.true_div or core.quant.div_as_compiled)")


@rule("scalar-div")
def check_scalar_div(mod: Module) -> List[Finding]:
    out = []
    cache: Dict = {}
    for node in ast.walk(mod.tree):
        f = None
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            f = _div_finding(mod, node, node.left, node.right, cache)
        elif isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Div):
            f = _div_finding(mod, node, node.target, node.value, cache)
        elif isinstance(node, ast.Call) \
                and mod.call_name(node) in ("torch.div", "torch.true_divide") \
                and len(node.args) == 2 \
                and not any(kw.arg == "rounding_mode"
                            and not (isinstance(kw.value, ast.Constant)
                                     and kw.value.value is None)
                            for kw in node.keywords):
            f = _div_finding(mod, node, node.args[0], node.args[1], cache)
        if f is not None:
            out.append(f)
    return out


# ---------------------------------------------------------------------------
# (d) TF32
# ---------------------------------------------------------------------------

_TF32_FLAGS = ("torch.backends.cuda.matmul.allow_tf32",
               "torch.backends.cudnn.allow_tf32")


@rule("tf32-toggle")
def check_tf32_toggle(mod: Module) -> List[Finding]:
    out = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                name = mod.dotted_name(tgt)
                if name in _TF32_FLAGS and not (
                        isinstance(node.value, ast.Constant)
                        and node.value.value is False):
                    out.append(Finding(
                        "tf32-toggle", mod.path, node.lineno,
                        f"{name} set to {ast.unparse(node.value)}: TF32 "
                        f"rounds float32 products to 10 mantissa bits; the "
                        f"reference pins HIGHEST precision, so it stays "
                        f"False"))
        elif isinstance(node, ast.Call) and mod.call_name(node) \
                == "torch.set_float32_matmul_precision":
            arg = node.args[0] if node.args else None
            if not (isinstance(arg, ast.Constant) and arg.value == "highest"):
                out.append(Finding(
                    "tf32-toggle", mod.path, node.lineno,
                    f"set_float32_matmul_precision("
                    f"{ast.unparse(arg) if arg is not None else ''}) lets "
                    f"float32 matmuls run in TF32 or bf16; the reference "
                    f"pins HIGHEST precision, so it stays 'highest'"))
    return out


# ---------------------------------------------------------------------------
# (e) guard hygiene: bare assert / silent except (the reference's)
# ---------------------------------------------------------------------------


@rule("bare-assert")
def check_bare_assert(mod: Module) -> List[Finding]:
    return [
        Finding("bare-assert", mod.path, node.lineno,
                "assert in library code: stripped under python -O and "
                "invisible to callers — raise ValueError (or a typed "
                "error) with a message instead")
        for node in ast.walk(mod.tree) if isinstance(node, ast.Assert)
    ]


@rule("silent-except")
def check_silent_except(mod: Module) -> List[Finding]:
    out = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        broad = node.type is None or mod.dotted_name(node.type) in (
            "Exception", "BaseException")
        silent = all(
            isinstance(st, ast.Pass)
            or (isinstance(st, ast.Expr)
                and isinstance(st.value, ast.Constant))
            for st in node.body)
        if broad and silent:
            out.append(Finding(
                "silent-except", mod.path, node.lineno,
                "broad except with a pass-only body swallows every "
                "failure silently — narrow to the exceptions actually "
                "expected, or handle/log them"))
    return out
