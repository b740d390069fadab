"""Per-device FLOPs, bytes, collectives and live memory of one traced step
(the port's counterpart, in intent, of ``repro.launch.hlo_analysis``).

The reference lowers and compiles a jitted step, then parses the SPMD HLO
text.  XLA's ``HloCostAnalysis`` visits ``while`` bodies once, so for
scan-over-layers models it undercounts by the layer count; the reference
recovers each loop's trip count from its condition's constant and
multiplies the body.  The port runs eagerly: every loop iteration
dispatches its ops again, so an op counted once per dispatch is already
trip-count exact.

:class:`OpAnalysis` is a ``TorchDispatchMode`` entered around the step
(in the dry run under ``FakeTensorMode``, so nothing is allocated):

  * ``flops``: 2*M*N*K per product, from ``torch.utils.flop_counter``'s
    formulas, and ``n_dots``, the products counted;
  * ``bytes``: operand + output bytes per op, with ``bytes_by_op``;
  * ``collectives``: per type (all_gather, all_reduce, reduce_scatter,
    all_to_all) the count and output bytes of the functional collectives
    DTensor issues, and their ``total_bytes``;
  * live memory: every new storage an op makes is live until its last
    tensor dies (a weakref finalizer), and the peak of their sum is kept.

**Per device.**  A mode entered outside DTensor's dispatch sees each
DTensor op at its global shape.  So the mode returns ``NotImplemented``
for an op with a DTensor argument: DTensor's own dispatch then runs, and
the ops it issues on the local shards (and the collectives it inserts)
come back through the mode, which counts them.  The op DTensor runs on
global fake tensors to infer an output's shape
(``ShardingPropagator._propagate_tensor_meta_non_cached``) is not
counted.  Every figure is one device's, as the reference's are.

**Which bytes count** (the reference's ``_NO_TRAFFIC`` / ``_SLICE_OPS``,
``hlo_analysis.py:41-60``, mapped to aten):

  ========================  =========================================
  HLO                       aten
  ========================  =========================================
  bitcast, tuple, gte,      views (``view``, ``expand``, ``permute``,
  parameter, constant       ``slice``, ``select``, ``t``, ...),
                            ``empty*``, ``detach``, ``wait_tensor``
  scatter,                  ``index_put(_)``, ``index_copy(_)``,
  dynamic-update-slice      ``index_add(_)``, ``scatter*``,
                            ``slice_scatter``, ``select_scatter``:
                            indices + updates, not the target
  gather, dynamic-slice     ``index``, ``gather``, ``index_select``,
                            ``embedding``: indices + output
  pad                       ``constant_pad_nd``: output
  copy                      ``clone``, ``_to_copy``, ``copy_``: output
  ========================  =========================================

**Kernels count as one op**, as a fusion's call site does in the
reference: while ``kernels.ops`` runs a kernel's plain version under this
mode (:meth:`OpAnalysis.kernel_call`), its products count towards
``flops``, but only the call's tensor arguments and outputs count as
bytes and as new memory, since the kernel keeps its intermediates on
chip.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten
from torch.utils.flop_counter import flop_registry

from repro_torch.sharding.spmd import is_dtensor

COLLECTIVES = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all")

# functional collectives (namespace _c10d_functional) -> type
_COLL = {"all_gather_into_tensor": "all_gather",
         "all_gather_into_tensor_coalesced": "all_gather",
         "all_reduce": "all_reduce", "all_reduce_coalesced": "all_reduce",
         "reduce_scatter_tensor": "reduce_scatter",
         "reduce_scatter_tensor_coalesced": "reduce_scatter",
         "all_to_all_single": "all_to_all"}

_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "detach", "alias",
               "lift_fresh", "wait_tensor", "_local_scalar_dense",
               "sym_size", "sym_stride", "sym_numel", "sym_storage_offset"}

# aten op -> (count the output, skip the first operand)
_SLICE_OPS = {}
for _n in ("index_put", "index_put_", "_index_put_impl_", "index_copy",
           "index_copy_", "index_add", "index_add_", "scatter", "scatter_",
           "scatter_add", "scatter_add_", "scatter_reduce",
           "scatter_reduce_", "slice_scatter", "select_scatter"):
    _SLICE_OPS[_n] = (False, True)
for _n in ("index", "gather", "index_select", "embedding",
           "constant_pad_nd", "clone", "_to_copy", "copy_", "copy"):
    _SLICE_OPS[_n] = (True, True)


def _tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


# per op: (name, flop formula, collective type, moves bytes, count the
# output, skip the first operand)
_OP_INFO = {}


def _op_info(func):
    packet = func._overloadpacket
    name, ns = packet.__name__, func.namespace
    coll = _COLL.get(name) if ns == "_c10d_functional" else None
    traffic = not (ns == "prim" or name in _NO_TRAFFIC or _is_view(func))
    return (name, flop_registry.get(packet), coll, traffic,
            *_SLICE_OPS.get(name, (True, False)))


def _propagator():
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    if not hasattr(ShardingPropagator, "_propagate_tensor_meta_non_cached"):
        raise RuntimeError("this torch's DTensor has no "
                           "_propagate_tensor_meta_non_cached: the op "
                           "analysis cannot tell its shape inference from "
                           "the local ops")
    return ShardingPropagator


class OpAnalysis(TorchDispatchMode):
    """Count one step's per-device work (see the module's docstring).
    ``args``: the step's inputs (DTensors or tensors, nested), whose local
    bytes are ``argument_bytes`` and are live throughout, not new."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = 0
        self.n_dots = 0
        self.bytes = 0
        self.by_op = {}
        self.coll_bytes = {c: 0 for c in COLLECTIVES}
        self.coll_n = {c: 0 for c in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._kernel = 0
        self._meta = 0
        self._out_spec = []
        self._tracked = set()
        self._args = {}
        for t in _locals(args):
            st = t.untyped_storage()
            self._args[id(st)] = st
        self.argument_bytes = sum(st.nbytes() for st in self._args.values())

    # -- mode ---------------------------------------------------------------
    def __enter__(self):
        from repro_torch.kernels import ops
        prop = _propagator()
        self._saved = (prop._propagate_tensor_meta_non_cached,
                       ops.kernel_scope)
        orig = self._saved[0]
        mode = self

        def shape_only(self_, op_schema):
            mode._meta += 1
            try:
                return orig(self_, op_schema)
            finally:
                mode._meta -= 1
        prop._propagate_tensor_meta_non_cached = shape_only
        ops.kernel_scope = self.kernel_call
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        _propagator()._propagate_tensor_meta_non_cached, ops.kernel_scope = \
            self._saved
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._meta:
            return func(*args, **kwargs)
        ins = tree_leaves((args, kwargs))
        if any(is_dtensor(t) for t in ins):
            return NotImplemented          # count DTensor's local ops
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, ins, out)
        return out

    # -- counting -------------------------------------------------------------
    def _count(self, func, args, kwargs, ins, out):
        info = _OP_INFO.get(func)
        if info is None:
            info = _OP_INFO[func] = _op_info(func)
        name, flop_fn, coll, traffic, count_out, skip_first = info
        if flop_fn is not None:
            self.flops += int(flop_fn(*args, **kwargs, out_val=out))
            self.n_dots += 1
        if self._kernel:
            return
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if coll is not None:
            self.coll_bytes[coll] += sum(_tensor_bytes(t) for t in outs)
            self.coll_n[coll] += 1
        if not traffic:
            return
        tin = [t for t in ins if isinstance(t, torch.Tensor)]
        b = sum(_tensor_bytes(t) for t in outs) if count_out else 0
        b += sum(_tensor_bytes(t) for t in tin[1 if skip_first else 0:])
        self.bytes += b
        self.by_op[name] = self.by_op.get(name, 0) + b
        for t in outs:
            self._track(t)

    def _track(self, t) -> None:
        """Count t's storage as live until its last tensor dies, unless it
        is an argument's or already counted."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._tracked or key in self._args:
            return
        n = st.nbytes()
        self._tracked.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key, n)

    def _release(self, key, n) -> None:
        self._tracked.discard(key)
        self.live -= n

    def kernel_call(self, name: str, fn, *args, **kwargs):
        """Run ``fn`` (a kernel's plain version) as one op named
        ``name``: its products count as flops; its tensor arguments and
        outputs count as bytes, its outputs as new memory.  Under autograd
        its gradient is one op too (``name + "_bwd"``, as the port's
        hand-written backward kernels are), whose intermediates, like the
        forward's, stay uncounted."""
        flat, spec = tree_flatten((args, kwargs))
        if torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad
                for t in flat):
            outs = _KernelGrad.apply(self, name, fn, spec, *flat)
            return tree_unflatten(list(outs), self._out_spec.pop())
        return self._scoped(name, lambda: fn(*args, **kwargs), flat)

    def _scoped(self, name: str, run, inputs, extra=()):
        """``run()`` as one op: uncounted inside but for its products;
        ``inputs``, ``extra`` and the outputs counted as bytes, the
        outputs as new memory."""
        self._kernel += 1
        try:
            out = run()
        finally:
            self._kernel -= 1
        if self._kernel:
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        tin = [t for t in list(inputs) + list(extra)
               if isinstance(t, torch.Tensor)]
        b = sum(_tensor_bytes(t) for t in outs + tin)
        self.bytes += b
        key = "kernel:" + name
        self.by_op[key] = self.by_op.get(key, 0) + b
        for t in outs:
            self._track(t)
        return out

    # -- results ------------------------------------------------------------
    def output_bytes(self, out) -> int:
        """Local bytes of the new storages ``out`` (the step's result)
        holds."""
        seen = {}
        for t in _locals(out):
            st = t.untyped_storage()
            if id(st) not in self._args:
                seen[id(st)] = st.nbytes()
        return sum(seen.values())

    def result(self) -> dict:
        """The keys ``hlo_analysis.analyze`` returns."""
        return {
            "flops": float(self.flops),
            "bytes": float(self.bytes),
            "n_dots": int(self.n_dots),
            "bytes_by_op": {k: float(v) for k, v in sorted(
                self.by_op.items(), key=lambda kv: -kv[1])[:12]},
            "collectives": {
                "total_bytes": float(sum(self.coll_bytes.values())),
                "per_op_bytes": {c: float(v)
                                 for c, v in self.coll_bytes.items()},
                "counts": dict(self.coll_n),
            },
        }


class _KernelGrad(torch.autograd.Function):
    """A kernel's plain version under autograd, counted as two ops: the
    forward, and the backward through the plain version's own graph
    (kept on the context, uncounted, as a kernel keeps its intermediates
    on chip)."""

    @staticmethod
    def forward(ctx, mode, name, fn, spec, *flat):
        ins = [t.detach().requires_grad_() if isinstance(t, torch.Tensor)
               and t.requires_grad else t for t in flat]
        args, kwargs = tree_unflatten(ins, spec)
        with torch.enable_grad():
            out = mode._scoped(name, lambda: fn(*args, **kwargs), ins)
        outs, out_spec = tree_flatten(out)
        mode._out_spec.append(out_spec)
        ctx.mode, ctx.name, ctx.ins, ctx.outs = mode, name, ins, outs
        return tuple(t.detach() for t in outs)

    @staticmethod
    def backward(ctx, *grads):
        need = [i for i, t in enumerate(ctx.ins)
                if isinstance(t, torch.Tensor) and t.requires_grad]
        pairs = [(o, g) for o, g in zip(ctx.outs, grads)
                 if g is not None and o.requires_grad]
        res = [None] * len(ctx.ins)
        if pairs and need:
            gin = ctx.mode._scoped(
                ctx.name + "_bwd", lambda: torch.autograd.grad(
                    [o for o, _ in pairs], [ctx.ins[i] for i in need],
                    [g for _, g in pairs], allow_unused=True),
                ctx.ins, [o for o, _ in pairs] + [g for _, g in pairs])
            for i, g in zip(need, gin):
                res[i] = g
        return (None, None, None, None, *res)


def _locals(tree):
    """The local tensors of a nested tree of DTensors / tensors."""
    for t in tree_leaves(tree):
        if is_dtensor(t):
            yield t._local_tensor
        elif isinstance(t, torch.Tensor):
            yield t


def analyze(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under :class:`OpAnalysis`;
    returns (its result, the analysis)."""
    with OpAnalysis(args) as oa:
        out = fn(*args, **kwargs)
    return out, oa
