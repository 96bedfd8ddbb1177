"""Flops profiler: a count of every aten op a step runs, by the JAX
package's rules, with a per-scope breakdown (port of
``deepspeed_tpu/profiling/flops_profiler/profiler.py``).

The JAX profiler walks the step's jaxpr; eager PyTorch has no jaxpr, so
this one counts the step as it runs: a ``TorchDispatchMode`` sees every
aten op below autograd, the backward's included, and counts it by the
JAX package's rules (``profiler.py:35-63``):

- a matmul (``mm``, ``bmm``, ``addmm``, ``baddbmm``, and so the matmul
  under ``linear``, ``matmul`` and ``einsum``) counts ``2·batch·m·n·k``,
  as ``dot_general`` does; a convolution ``2·out·kernel taps``;
- an elementwise op (:data:`ELEMENTWISE`) one per output element, a
  reduction (:data:`REDUCE`) one per input element; copies, views,
  comparisons, indexing, random draws and collectives count nothing;
- an aten op that is one op here and several primitives in JAX
  (softmax, log-softmax, logsumexp, gelu, layer norm, the activations'
  backwards: :data:`COMPOSITE`) counts the JAX decomposition's elements,
  ``a·n + b·rows`` for ``n`` input elements in ``rows`` rows.

Scopes (the reference's per-module table): an ``nn.Module``'s forward
pushes its path (forward pre/post hooks on the profiled module's
submodules), and :func:`named_scope` pushes a name where the port's
functional models call it, at the JAX models' ``jax.named_scope`` sites
(``layer_<i>``, ``attention``, ``mlp``).  An op of the backward counts
in the scope of the forward op whose autograd node runs it: each
forward output's ``grad_fn`` is tagged with the scope it was made in,
and the backward reads the running node's tag
(``torch._C._current_autograd_node``), so a module's backward is
attributed to its path without hooks on its inputs and outputs.

The hand-written kernels run by ctypes on ``data_ptr`` and are invisible
to the dispatch mode.  Each kernel wrapper therefore calls
:func:`kernel_launch` after a CUDA launch with its plain version and the
launch's inputs; with a profiler counting, the plain version runs on
``meta`` copies of the inputs (shapes only: no data, no device work)
inside the counting mode, so **a launch counts exactly what the
profiler counts for its plain version on the same inputs**, and a
profile does not depend on the device.  The profiler never runs a plain
version on the card.

The profiled step's numerics are those of a step without the profiler:
the mode calls every op as it was called.
"""

import contextlib
import time
import weakref
from collections import defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ...utils.logging import logger

__all__ = ["COMPOSITE", "ELEMENTWISE", "REDUCE", "FlopCounter", "FlopsProfile",
           "FlopsProfiler", "aten_flops", "count_fn_flops",
           "get_model_profile", "kernel_launch", "named_scope",
           "params_count"]

# the matmuls: dot_general's 2·batch·m·n·k
MATMUL = frozenset(("mm", "bmm", "addmm", "baddbmm", "addbmm", "dot",
                    "vdot", "mv", "addmv", "_scaled_mm"))
CONVOLUTION = frozenset(("convolution", "_convolution"))

# elementwise ops counted as one op per OUTPUT element (JAX: add, sub,
# mul, div, max, min, exp, log, tanh, pow, rsqrt, sqrt, neg, logistic,
# erf, integer_pow, and, or, xor, select_n); in-place forms count alike
ELEMENTWISE = frozenset((
    "add", "sub", "rsub", "mul", "div", "true_divide", "reciprocal",
    "maximum", "minimum", "fmax", "fmin", "clamp_min", "clamp_max", "exp",
    "log", "tanh", "pow", "rsqrt", "sqrt", "neg", "sigmoid", "erf", "where",
    "logical_and", "logical_or", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_xor", "__and__", "__or__", "__xor__", "__iand__", "__ior__",
    "__ixor__", "relu", "threshold_backward", "masked_fill",
))
# two elementwise ops per output element: JAX's clip is max then min,
# addcmul/addcdiv a product (quotient) and a sum, lerp a difference
# scaled and added back (counted as two)
ELEMENTWISE_2 = frozenset(("clamp", "clip", "addcmul", "addcdiv", "lerp",
                           "hardtanh"))
# reductions counted as one op per INPUT element (JAX: reduce_sum,
# reduce_max, reduce_min, reduce_prod, argmax, argmin)
REDUCE = frozenset(("sum", "amax", "amin", "max", "min", "prod", "argmax",
                    "argmin", "nansum"))

# aten ops that JAX computes as several primitives: ``(a, b)`` counts
# a·n + b·rows for an input of n elements in rows rows along the op's
# dim, the count of the JAX function on an [rows, n/rows] input
# (measured with count_fn_flops on jax 0.9: forward, and the vjp less
# the forward it recomputes)
COMPOSITE = {
    "_softmax": (5, 1),                     # jax.nn.softmax
    "_softmax_backward_data": (6, 6),       # its vjp
    "_log_softmax": (5, 2),                 # jax.nn.log_softmax
    "_log_softmax_backward_data": (3, 2),
    "logsumexp": (4, 4),                    # jax.scipy.special.logsumexp
    "mean": (1, 1),                         # reduce_sum, then div
    "var": (3, 2), "std": (3, 3), "var_mean": (3, 2),
    "linalg_vector_norm": (2, 1), "norm": (2, 1),
    "gelu": (8, 0),                          # jax.nn.gelu, tanh form
    "gelu_backward": (11, 0),
    "tanh_backward": (3, 0),
    "sigmoid_backward": (3, 0),
    "silu": (2, 0), "silu_backward": (5, 0),
    "native_layer_norm": (7, 4),            # models/layers.py layer_norm
    "native_layer_norm_backward": (10, 7),
}
# gelu's exact (erf) form: jax.nn.gelu(approximate=False)
GELU_ERF = {"gelu": (4, 0), "gelu_backward": (9, 0)}

_SCOPE_KEY = "ds_flops_scope"
# live outputs waiting for their autograd node (an optimizer's in-place
# ops under no_grad never get one): the newest are kept
_MAX_DEFERRED = 4096
_TOP = "<top>"


def _numel(t):
    return t.numel() if isinstance(t, torch.Tensor) else 1


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (tuple, list)):
        for y in x:
            t = _first_tensor(y)
            if t is not None:
                return t
    return None


def _matmul_flops(name, args):
    if name in ("addmm", "baddbmm", "addbmm", "addmv"):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    if name in ("dot", "vdot"):
        return 2 * a.numel()
    if name in ("mv", "addmv"):
        return 2 * a.shape[0] * a.shape[1]
    # [..., m, k] @ [..., k, n]
    k = a.shape[-1]
    return 2 * (a.numel() // max(k, 1)) * k * b.shape[-1]


def _rows(args, kwargs, n, dim_arg=1):
    """Rows of a reduction over one dim: elements / that dim's size."""
    x = args[0]
    dim = kwargs.get("dim", args[dim_arg] if len(args) > dim_arg else -1)
    if isinstance(dim, (list, tuple)):
        dims = [d % max(x.dim(), 1) for d in dim] if dim else \
            list(range(x.dim()))
    elif dim is None:
        dims = list(range(x.dim()))
    else:
        dims = [dim % max(x.dim(), 1)] if x.dim() else []
    size = 1
    for d in dims:
        size *= x.shape[d] if x.dim() else 1
    return n // max(size, 1)


def aten_flops(func, args, kwargs, out):
    """``(flops, kind)`` of one aten op by the JAX package's rules; kind
    is "matmul", "elementwise" or None (counts nothing)."""
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.startswith("_") \
            and name[:-1] in ELEMENTWISE | ELEMENTWISE_2 | REDUCE:
        name = name[:-1]
    if name in MATMUL:
        flops = _matmul_flops(name, args)
        if name in ("addmm", "baddbmm", "addmv"):
            # the bias added to the product, as dense's separate add
            flops += _numel(out)
        return flops, "matmul"
    if name in CONVOLUTION:
        w = args[1]
        taps = w.numel() // max(w.shape[0], 1)
        flops = 2 * _numel(out) * taps
        if len(args) > 2 and isinstance(args[2], torch.Tensor):
            flops += _numel(out)
        return flops, "matmul"
    if name == "convolution_backward":
        grad_out, x, w = args[0], args[1], args[2]
        taps = w.numel() // max(w.shape[0], 1)
        mask = args[-1] if len(args) > 9 else (True, True, True)
        flops = 2 * grad_out.numel() * taps * (int(mask[0]) + int(mask[1]))
        return flops, "matmul"
    if name in ELEMENTWISE:
        t = _first_tensor(out)
        return (t.numel() if t is not None else 0), "elementwise"
    if name in ELEMENTWISE_2:
        t = _first_tensor(out)
        return (2 * t.numel() if t is not None else 0), "elementwise"
    if name in REDUCE:
        x = args[0]
        if not isinstance(x, torch.Tensor) or (
                name in ("max", "min") and len(args) > 1
                and isinstance(args[1], torch.Tensor)):
            # the binary max/min: elementwise
            t = _first_tensor(out)
            return (t.numel() if t is not None else 0), "elementwise"
        return x.numel(), "elementwise"
    rule = COMPOSITE.get(name)
    if rule is not None:
        if name in GELU_ERF and kwargs.get(
                "approximate", args[-1] if len(args) > 1 and
                isinstance(args[-1], str) else "none") == "none":
            rule = GELU_ERF[name]
        a, b = rule
        if name in ("_softmax_backward_data", "_log_softmax_backward_data",
                    "gelu_backward", "tanh_backward", "sigmoid_backward",
                    "silu_backward"):
            x = args[1] if name in ("_softmax_backward_data",
                                    "_log_softmax_backward_data") \
                else args[0]
            dim = args[2] if name.endswith("_data") else -1
            n = x.numel()
            rows = n // max(x.shape[dim], 1) if x.dim() else n
        elif name in ("native_layer_norm", "native_layer_norm_backward"):
            x = args[0] if name == "native_layer_norm" else args[1]
            shape = args[1] if name == "native_layer_norm" else args[2]
            n = x.numel()
            rows = n // max(int(np.prod(shape)), 1)
        elif name in ("gelu", "silu"):
            n, rows = args[0].numel(), 0
        else:
            n = args[0].numel()
            rows = _rows(args, kwargs, n)
        return a * n + b * rows, "elementwise"
    return 0, None


# the profiler counting in this process (one at a time)
_ACTIVE = [None]
# callables ``(name, plain, args, kwargs)`` told of every kernel launch:
# the overlap model's pricer while it records a phase
_LAUNCH_PRICERS = []


class _CountingMode(TorchDispatchMode):
    def __init__(self, profiler):
        super().__init__()
        self.profiler = profiler

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        prof = self.profiler
        if prof._kernel is None:
            prof._tag_pending()
        out = func(*args, **kwargs)
        prof._record(func, args, kwargs, out)
        return out


@contextlib.contextmanager
def named_scope(name):
    """Push ``name`` on the counting profiler's scope path for the body
    (the port of ``jax.named_scope`` at the JAX models' scope sites);
    nothing without a profiler counting."""
    prof = _ACTIVE[0]
    if prof is None:
        yield
        return
    prof._stack.append(str(name))
    try:
        yield
    finally:
        prof._tag_pending()
        prof._tag_deferred()
        prof._stack.pop()


def kernel_launch(name, plain, *args, **kwargs):
    """Count one launch of the hand-written kernel ``name`` as the
    profiler counts its plain version ``plain(*args, **kwargs)``: the
    plain version runs on ``meta`` copies of the tensors (shapes only)
    inside the counting mode.  Called by every kernel wrapper after its
    CUDA launch; returns at once when no profiler is counting.  The
    overlap model's pricer, while it records, prices the launch too
    (:func:`~deepspeed_tpu_torch.profiling.overlap.launch_cost`)."""
    for price in _LAUNCH_PRICERS:
        price(name, plain, args, kwargs)
    prof = _ACTIVE[0]
    if prof is None or not prof.counting:
        return None
    return prof._count_plain(name, plain, args, kwargs)


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("meta")
    if isinstance(x, tuple):
        return tuple(_to_meta(y) for y in x)
    if isinstance(x, list):
        return [_to_meta(y) for y in x]
    return x


def params_count(params):
    """Elements of a param tree (dicts, lists, tensors or arrays) or of
    an ``nn.Module``'s parameters."""
    if isinstance(params, torch.nn.Module):
        return int(sum(p.numel() for p in params.parameters()))
    if isinstance(params, dict):
        return int(sum(params_count(v) for v in params.values()))
    if isinstance(params, (list, tuple)):
        return int(sum(params_count(v) for v in params))
    return int(np.prod(np.shape(params))) if np.shape(params) else 1


class FlopCounter:
    """The counting state of one profile: totals by kind (``matmul``,
    ``elementwise``), by scope, by phase, and by hand-written kernel."""

    def __init__(self):
        self.reset()
        self.counting = False
        self._mode = None
        self._stack = []
        self._phase = None
        self._kernel = None
        self._pending = []
        self._deferred = []
        self._hooks = []

    def reset(self):
        self.matmul_flops = 0
        self.elementwise_flops = 0
        self.by_scope = defaultdict(int)
        self.by_phase = defaultdict(int)
        self.by_op = defaultdict(int)
        self.kernels = {}

    @property
    def flops(self):
        return self.matmul_flops + self.elementwise_flops

    # -- counting -------------------------------------------------------
    def start(self, phase="step", module=None):
        """Start counting (``phase`` names what follows in
        :attr:`by_phase`); ``module``'s submodules push their paths."""
        if self.counting:
            raise RuntimeError("the flops profiler is already counting")
        if _ACTIVE[0] is not None:
            raise RuntimeError("another flops profiler is counting")
        self._phase = phase
        if module is not None:
            self._hook(module)
        _ACTIVE[0] = self
        self.counting = True
        self._mode = _CountingMode(self)
        self._mode.__enter__()

    def stop(self):
        if not self.counting:
            return
        self._mode.__exit__(None, None, None)
        self._mode = None
        self.counting = False
        self._tag_pending()
        self._tag_deferred()
        _ACTIVE[0] = None
        for h in self._hooks:
            h.remove()
        self._hooks = []
        self._stack = []

    @contextlib.contextmanager
    def count(self, phase="step", module=None):
        self.start(phase, module)
        try:
            yield self
        finally:
            self.stop()

    def _hook(self, module):
        for path, sub in module.named_modules():
            if not path:
                continue

            def pre(mod, inputs, path=path):
                self._stack.append(path.split(".")[-1])

            def post(mod, inputs, outputs):
                self._tag_pending()
                self._tag_deferred()
                if self._stack:
                    self._stack.pop()

            self._hooks.append(sub.register_forward_pre_hook(pre))
            self._hooks.append(sub.register_forward_hook(post))

    def _scope(self):
        node = torch._C._current_autograd_node()
        if node is not None:
            return node.metadata.get(_SCOPE_KEY, _TOP)
        return "/".join(self._stack) if self._stack else _TOP

    def _tag_pending(self):
        """Tag the grad_fn of the forward outputs made since the last op
        (autograd attaches it after the op returns) with their scope.  A
        live output without one yet (made inside an autograd Function's
        forward, whose node is attached when the Function returns) waits
        for :meth:`_tag_deferred`, at its scope's end."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        for ref, scope in pending:
            t = ref()
            if t is None:
                continue
            if t.grad_fn is not None:
                t.grad_fn.metadata.setdefault(_SCOPE_KEY, scope)
            else:
                self._deferred.append((ref, scope))
        if len(self._deferred) > _MAX_DEFERRED:
            del self._deferred[:-_MAX_DEFERRED]

    def _tag_deferred(self):
        """At a scope's end: tag the deferred outputs that have a grad_fn
        by now, and forget the rest."""
        deferred, self._deferred = self._deferred, []
        for ref, scope in deferred:
            t = ref()
            if t is not None and t.grad_fn is not None:
                t.grad_fn.metadata.setdefault(_SCOPE_KEY, scope)

    def _record(self, func, args, kwargs, out):
        flops, kind = aten_flops(func, args, kwargs, out)
        backward = torch._C._current_autograd_node() is not None
        scope = self._scope()
        # every forward output (grad mode is off inside an autograd
        # Function's forward, whose outputs get their node after it)
        if not backward and self._kernel is None:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for t in outs:
                if isinstance(t, torch.Tensor) and t.is_floating_point() \
                        and t.device.type != "meta":
                    self._pending.append((weakref.ref(t), scope))
        if not flops:
            return
        if kind == "matmul":
            self.matmul_flops += flops
        else:
            self.elementwise_flops += flops
        self.by_scope[scope] += flops
        self.by_phase[self._phase] += flops
        self.by_op[func.overloadpacket.__name__] += flops
        if self._kernel is not None:
            rec = self.kernels[self._kernel]
            rec["flops"] += flops
            if kind == "matmul":
                rec["matmul_flops"] += flops

    def _count_plain(self, name, plain, args, kwargs):
        rec = self.kernels.setdefault(
            name, {"launches": 0, "flops": 0, "matmul_flops": 0})
        before = rec["flops"]
        outer, self._kernel = self._kernel, name
        try:
            with torch.no_grad():
                plain(*_to_meta(args), **{k: _to_meta(v)
                                           for k, v in kwargs.items()})
        finally:
            self._kernel = outer
        rec["launches"] += 1
        return rec["flops"] - before

    def kernel_flops(self, matmul_only=False):
        key = "matmul_flops" if matmul_only else "flops"
        return sum(rec[key] for rec in self.kernels.values())


def count_fn_flops(fn, *args, by_scope=None, **kwargs):
    """FLOPs of running ``fn(*args, **kwargs)`` (on whatever device its
    tensors are).  Returns ``(flops, by_scope)``."""
    counter = FlopCounter()
    with counter.count("fn"):
        fn(*args, **kwargs)
    if by_scope is not None:
        for k, v in counter.by_scope.items():
            by_scope[k] = by_scope.get(k, 0) + v
        return counter.flops, by_scope
    return counter.flops, dict(counter.by_scope)


def _fmt(n):
    for unit, div in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if n >= div:
            return f"{n / div:.2f} {unit}"
    return f"{n:.0f} "


def get_model_profile(model=None, batch=None, params=None, fn=None,
                      args=None, train=False, as_string=False, top_modules=3,
                      print_profile=True, device=None, seed=0):
    """Profile a model or a bare function (reference
    ``get_model_profile``, ``profiler.py:738``).

    Either ``model`` plus ``batch`` — a port model (``init``/``apply``:
    ``params`` default to ``model.init(seed)`` on ``device``) or any
    ``nn.Module`` (called on ``batch``) — or ``fn`` plus ``args``.
    ``train=True`` counts the forward and its backward (the gradient of
    the output's sum, as the JAX profiler's ``jax.grad``).  ``device``
    None is the CUDA card (and raises without one); the tensors of
    ``batch`` and ``params`` are moved there.  Returns ``(flops, macs,
    params)``, formatted strings if ``as_string``."""
    from ...utils.device import resolve_device

    counter = FlopCounter()
    n_params = 0
    if fn is None:
        assert model is not None and batch is not None
        dev = resolve_device(device, "get_model_profile")
        batch = _move(batch, dev)
        module = model if isinstance(model, torch.nn.Module) else None
        if hasattr(model, "apply") and hasattr(model, "init") \
                and not isinstance(model, type):
            if params is None:
                params = model.init(seed)
            params = _leaves_to(params, dev, requires_grad=train)
            n_params = params_count(params)

            def run():
                return model.apply(params, batch, rng=None, train=train)
        else:
            model.to(dev)
            n_params = params_count(model)

            def run():
                return model(*batch) if isinstance(batch, tuple) \
                    else model(batch)
        with counter.count("forward_backward" if train else "forward",
                           module=module):
            with torch.set_grad_enabled(train):
                out = run()
                if train:
                    _first_tensor(out).float().sum().backward()
    else:
        args = tuple(args or ())
        n_params = params_count(args[0]) if args else 0
        with counter.count("fn"):
            fn(*args)
    flops = counter.flops
    macs = flops // 2
    if print_profile:
        FlopsProfile.from_counter(counter, n_params).print(
            top_modules=top_modules)
    if as_string:
        return (f"{_fmt(flops)}FLOPs", f"{_fmt(macs)}MACs",
                f"{_fmt(n_params)}params")
    return flops, macs, n_params


def _move(x, device):
    if isinstance(x, dict):
        return {k: _move(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_move(v, device) for v in x)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
        if not x.is_floating_point() and x.dtype != torch.bool:
            x = x.long()
    return x.to(device) if isinstance(x, torch.Tensor) else x


def _leaves_to(tree, device, requires_grad):
    if isinstance(tree, dict):
        return {k: _leaves_to(v, device, requires_grad)
                for k, v in tree.items()}
    t = tree if isinstance(tree, torch.Tensor) else \
        torch.from_numpy(np.asarray(tree))
    t = t.detach().to(device)
    if requires_grad and t.is_floating_point():
        t.requires_grad_(True)
    return t


class FlopsProfile:
    """One profile: total FLOPs and MACs, params, the per-scope table and
    its split (matmul and elementwise, by phase, by kernel), and the
    profiled wall time."""

    def __init__(self, flops, macs, params, by_scope=None, wall_ms=None,
                 matmul_flops=None, by_phase=None, kernels=None, device=None,
                 dtype=torch.bfloat16):
        self.flops = flops
        self.macs = macs
        self.params = params
        self.by_scope = dict(by_scope or {})
        self.wall_ms = wall_ms
        self.matmul_flops = matmul_flops
        self.by_phase = dict(by_phase or {})
        self.kernels = {k: dict(v) for k, v in (kernels or {}).items()}
        self.device = device
        self.dtype = dtype

    @classmethod
    def from_counter(cls, counter, params, wall_ms=None, device=None,
                     dtype=torch.bfloat16):
        return cls(counter.flops, counter.flops // 2, params,
                   by_scope=counter.by_scope, wall_ms=wall_ms,
                   matmul_flops=counter.matmul_flops,
                   by_phase=counter.by_phase, kernels=counter.kernels,
                   device=device, dtype=dtype)

    @property
    def elementwise_flops(self):
        if self.matmul_flops is None:
            return None
        return self.flops - self.matmul_flops

    def achieved_tflops(self):
        if not self.wall_ms:
            return None
        return self.flops / (self.wall_ms / 1e3) / 1e12

    def mfu(self, device=None):
        """Model-FLOPs utilisation against the card's peak for the
        profile's dtype, from the ONE table ``chip_smoke.py`` quotes
        (:mod:`..utilization`)."""
        if not self.wall_ms:
            return None
        from ..utilization import chip_peak_tflops

        device = device if device is not None else self.device
        if isinstance(device, torch.device) and device.type != "cuda":
            device = str(device)
        return self.achieved_tflops() / chip_peak_tflops(device, self.dtype)

    def scopes(self, module_depth=-1):
        """The per-scope table, each path cut to ``module_depth`` names
        (-1: whole paths), largest first."""
        table = defaultdict(int)
        for name, fl in self.by_scope.items():
            if module_depth >= 0 and name != _TOP:
                name = "/".join(name.split("/")[:module_depth]) or _TOP
            table[name] += fl
        return sorted(table.items(), key=lambda kv: -kv[1])

    def print(self, top_modules=3, log=None, module_depth=-1):
        log = log or logger.info
        log(f"flops profile: {_fmt(self.flops)}FLOPs, {_fmt(self.macs)}MACs, "
            f"{_fmt(self.params)}params")
        if self.matmul_flops is not None and self.flops:
            log(f"  matmul {_fmt(self.matmul_flops)}FLOPs, elementwise and "
                f"reductions {_fmt(self.elementwise_flops)}FLOPs "
                f"({100.0 * self.elementwise_flops / self.flops:.2f}%)")
        for name, rec in sorted(self.kernels.items()):
            log(f"  kernel {name}: {rec['launches']} launch(es), "
                f"{_fmt(rec['flops'])}FLOPs as its plain version counts")
        if self.wall_ms:
            mfu = self.mfu()
            log(f"  wall: {self.wall_ms:.2f} ms -> "
                f"{self.achieved_tflops():.2f} TFLOP/s achieved"
                + (f" (MFU {mfu:.3f})" if mfu is not None else ""))
        for name, fl in self.scopes(module_depth)[:top_modules]:
            log(f"  {100.0 * fl / max(self.flops, 1):5.1f}%  {_fmt(fl)}FLOPs  {name}")


class FlopsProfiler:
    """Engine-attached profiler (reference ``FlopsProfiler``,
    ``profiler.py:11``): counts the engine's training step as it runs at
    the configured ``profile_step`` — the first micro-batch's forward
    and backward (× the gradient accumulation steps, as the JAX
    profiler's ``profile_train_step`` multiplies its traced micro-batch)
    and the optimizer step (its exchange, clip and update) — and times
    that step between two synchronizations."""

    def __init__(self, engine):
        self.engine = engine
        self.profile = None
        self.counter = FlopCounter()
        self._micro = None   # the micro-batch's (scopes, matmul, kernels)
        self._t0 = None
        self.active = False

    # -- the engine's hooks ----------------------------------------------
    def begin_step(self):
        """The profiled step starts (its first forward)."""
        from ...utils.timer import device_fence

        self.counter.reset()
        self.active = True
        device_fence(self.engine.device)
        self._t0 = time.perf_counter()
        self.counter.start("forward_backward", module=self._module())

    def _module(self):
        mod = self.engine.module
        return mod if isinstance(mod, torch.nn.Module) else None

    def end_micro_batch(self):
        """The first micro-batch's backward returned."""
        c = self.counter
        if c.counting and c._phase == "forward_backward":
            c.stop()
            self._micro = (dict(c.by_scope), c.matmul_flops,
                           {k: dict(v) for k, v in c.kernels.items()})

    def begin_apply(self):
        if self.active and not self.counter.counting:
            self.counter.start("step")

    def end_step(self):
        """The profiled step's update returned: build the profile."""
        from ...utils.timer import device_fence

        if not self.active:
            return None
        self.counter.stop()
        device_fence(self.engine.device)
        wall_ms = (time.perf_counter() - self._t0) * 1e3
        self.active = False
        eng = self.engine
        # the counted forward-backward's runs in the step: one per
        # micro-batch, or one for a pipeline's whole batch
        acc = eng._fwd_bwd_multiplicity()
        c = self.counter
        scopes, matmul, kernels = self._micro or (dict(c.by_scope),
                                                  c.matmul_flops, c.kernels)
        fb = c.by_phase.get("forward_backward", 0)
        apply_flops = c.by_phase.get("step", 0)
        total = fb * acc + apply_flops
        # the micro-batch's counts scale with the accumulation steps, the
        # optimizer step's count once
        by_scope = defaultdict(int)
        for k, v in c.by_scope.items():
            by_scope[k] += v + (acc - 1) * scopes.get(k, 0)
        kernels = {k: {kk: vv * acc for kk, vv in v.items()}
                   for k, v in kernels.items()}
        for k, v in c.kernels.items():
            # a kernel the optimizer step launched counts once
            if k not in kernels:
                kernels[k] = dict(v)
        self.profile = FlopsProfile(
            flops=total, macs=total // 2, params=eng._param_count(),
            by_scope=by_scope, wall_ms=wall_ms,
            matmul_flops=matmul * acc + (c.matmul_flops - matmul),
            by_phase={"forward_backward": fb * acc, "step": apply_flops},
            kernels=kernels, device=eng.device, dtype=eng.compute_dtype)
        self._micro = None
        return self.profile

    def profile_train_step(self, batch, wall_ms=None):
        """Profile one training step on ``batch`` (each of the
        accumulation steps' micro-batches): the engine takes the step,
        with the numerics of a step without the profiler.  Returns the
        :class:`FlopsProfile`; ``wall_ms`` given replaces the step's own
        time."""
        eng = self.engine
        acc = eng.gradient_accumulation_steps()
        attached, eng.flops_profiler = eng.flops_profiler, self
        eng._flops_request = True
        try:
            eng.train_batch(iter([batch] * acc))
        finally:
            eng._flops_request = False
            eng.flops_profiler = attached
        if wall_ms is not None and self.profile is not None:
            self.profile.wall_ms = wall_ms
        return self.profile

    def print_model_profile(self, batch=None, top_modules=3, module_depth=-1):
        if self.profile is None:
            assert batch is not None, "first call needs a sample batch"
            self.profile_train_step(batch)
        self.profile.print(top_modules=top_modules, module_depth=module_depth)
