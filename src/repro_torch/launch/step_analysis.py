"""A cell's per-device costs read from the step the port executes (the
port's counterpart of the JAX package's src/repro/launch/hlo_analysis.py).

The JAX package compiles a cell's step for 256 or 512 forced host
devices and reads the compiled program: its flops from XLA's cost
analysis, its collective bytes from the HLO text, its buffer sizes from
the memory analysis. The port has no compiled program: its step is eager
PyTorch. measure_step runs that step once, for one rank, on the meta
device (shapes and dtypes, no storage and no arithmetic), under a
TorchDispatchMode that reads every tensor op it dispatches:

- flops: torch.utils.flop_counter's formulas over the ops dispatched
  (what FlopCounterMode counts), plus the products the kernel ops report
  (kernels/__init__.py `reported`: their plain versions' count, so the
  total is what FlopCounterMode counts of the step on the CPU);
- coll: each collective's result bytes on the rank by type and by mesh
  axis, as parallel/collectives.py counts them while the step issues
  them;
- args_bytes: the rank's inputs (its shards of the state or parameters,
  its rows, its caches);
- temp_bytes: the peak of live tensor storage above the arguments, each
  storage an op creates tracked until it is freed;
- bytes_accessed: operands plus results of every aten op dispatched,
  views and allocations left out (they move no bytes), plus what the
  kernel ops report: the eager step's traffic, each op reading its inputs
  from and writing its outputs to device memory.

Over a mesh of more than one device the step runs inside a fake process
group of the mesh's size (torch.testing's "fake" backend: collectives
return at once, on meta tensors with no data) in this one process, with
a DeviceMesh over it laid out as launch/mesh.py lays out the production
mesh. One rank stands for all: every rank of the production meshes holds
shards of the same shapes (the rules split every dimension evenly, and
the padding is the same on each rank) and runs the same ops on them, so
its counts are every rank's; tests/test_torch_step_analysis.py holds the
last rank to rank 0 on each arch family.

On a CUDA tensor the same meter counts the step the card runs (the
kernel ops report their work as on meta): chip_smoke.py holds the two to
one another.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels as K
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import steps as St
from repro_torch.launch.memory_model import tree_bytes
from repro_torch.launch.roofline import CollectiveStats
from repro_torch.models import model as Mo
from repro_torch.models.env import Env, mesh_axes
from repro_torch.optim.adamw import AdamWConfig, tree_leaves, tree_map
from repro_torch.parallel import collectives as C
from repro_torch.parallel import rules

aten = torch.ops.aten

# ops that move no bytes: allocations (views are told apart by schema)
_ALLOC = {aten.empty.memory_format, aten.empty_strided.default,
          aten.new_empty.default, aten.new_empty_strided.default,
          aten.empty_like.default}
# the metadata queries FlopCounterMode leaves to the default handling
_QUERY = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
          aten.is_contiguous.memory_format,
          aten.is_strides_like_format.default,
          aten.is_non_overlapping_and_dense.default, aten.size.default,
          aten.sym_size.default, aten.stride.default,
          aten.sym_stride.default, aten.storage_offset.default,
          aten.sym_storage_offset.default, aten.numel.default,
          aten.sym_numel.default, aten.dim.default}


def _mm(a, b, *_, **__):
    return 2 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(a, b, *_, **__):
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


# flop_counter's formulas for the products a step dispatches most, read
# off the shapes directly (the same counts, without its pytree walk)
_FAST_FLOPS = {aten.mm.default: _mm, aten.bmm.default: _bmm,
               aten.addmm.default: lambda c, a, b, *_, **__: _mm(a, b),
               aten.baddbmm.default: lambda c, a, b, *_, **__: _bmm(a, b)}


@dataclass
class StepCost:
    """What one rank's step does, each field the counterpart of a figure
    of the JAX package's analyze_cell: flops (cost_analysis "flops"),
    coll (parse_collectives), args_bytes (argument_size_in_bytes),
    temp_bytes (temp_size_in_bytes), bytes_accessed ("bytes accessed"),
    units (_unit_lowerings: {"segment", "trip", "unit_flops"} a
    segment). seconds: the measurement's wall time."""
    flops: float = 0.0
    coll: CollectiveStats = field(default_factory=CollectiveStats)
    args_bytes: int = 0
    temp_bytes: int = 0
    bytes_accessed: int = 0
    kernel_flops: float = 0.0
    units: List[Dict[str, Any]] = field(default_factory=list)
    seconds: float = 0.0


def _sig(xs) -> tuple:
    """A hashable stand-in for an op's arguments: each tensor's shape,
    strides and dtype, a list's items', any other value itself."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out += (x.shape, x.stride(), x.dtype)
        elif isinstance(x, (list, tuple)):
            out.append(_sig(x))
        else:
            out.append(x)
    return tuple(out)


def _nbytes(xs) -> int:
    n = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
        elif isinstance(x, (list, tuple)):
            n += _nbytes(x)
    return n


def _outs(out):
    return out if isinstance(out, (list, tuple)) else (out,)


def _remake(spec):
    """The fresh meta tensors of a memo entry's result."""
    if isinstance(spec, list):
        return tuple(_remake(s) for s in spec)
    shape, stride, dtype = spec
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def _spec(out):
    """(shape, stride, dtype) of a result, a list of them for a tuple of
    tensors, None for anything else."""
    if isinstance(out, torch.Tensor):
        return (out.shape, out.stride(), out.dtype)
    if isinstance(out, (list, tuple)) and all(
            isinstance(t, torch.Tensor) for t in out):
        return [(t.shape, t.stride(), t.dtype) for t in out]
    return None


_QUERY_OP, _OTHER_OP = 0, 1  # handled by default / run as they are


def _how(func):
    """How the meter takes an op: _QUERY_OP, _OTHER_OP (not aten), or
    (counted: it moves bytes, functional: no alias and no mutation in its
    schema, so its result is fresh storage; composite: it decomposes, as
    FlopCounterMode decomposes it; flops: its formula or None)."""
    if func in _QUERY:
        return _QUERY_OP
    if func.namespace != "aten":
        return _OTHER_OP
    schema = func._schema
    aliased = any(a.alias_info is not None for a in schema.arguments) or \
        any(r.alias_info is not None for r in schema.returns)
    flops = _FAST_FLOPS.get(func) or flop_registry.get(func._overloadpacket)
    composite = flops is None and torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
    return (not func.is_view and func not in _ALLOC, not aliased, composite,
            flops)


class _Meter(TorchDispatchMode):
    """Counts what the ops dispatched under it do (see the module
    docstring). On the meta device a functional op's result, its
    flops and its bytes are taken from its first call with the same
    argument shapes: a meta op computes nothing else, and the step
    repeats the same ops tile after tile and layer after layer."""

    def __init__(self, args):
        super().__init__()
        # the step's device: a tensor elsewhere (a meta tensor a step on
        # the card makes for shapes alone) holds none of its memory
        self.device = args[0].device.type if args else "meta"
        self.flops = 0
        self.kernel_flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        # id(a weakref to a storage) -> (the weakref, storage key, bytes)
        self.refs: Dict[int, tuple] = {}
        self.keys = {x.untyped_storage()._cdata for x in args}
        self.memo: Optional[dict] = {} if self.device == "meta" else None
        self.hows: Dict[Any, Any] = {}

    # ---- storage ------------------------------------------------------------
    def _free(self, ref):
        _, key, n = self.refs.pop(id(ref))
        self.keys.discard(key)
        self.live -= n

    def track(self, out):
        """Add the storages of out's tensors that are new."""
        for t in _outs(out):
            if not isinstance(t, torch.Tensor) or t.device.type != self.device:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.keys:
                continue
            n = st.nbytes()
            self.keys.add(key)
            ref = weakref.ref(st, self._free)
            self.refs[id(ref)] = (ref, key, n)
            self.live += n
            if self.live > self.peak:
                self.peak = self.live

    def kernel(self, flops, nbytes, out):
        """kernels.ANALYSIS's sink: a kernel op's work and result."""
        self.flops += flops
        self.kernel_flops += flops
        self.bytes += nbytes
        self.track(out)

    # ---- ops ----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        how = self.hows.get(func)
        if how is None:
            how = self.hows[func] = _how(func)
        if how is _QUERY_OP:
            return NotImplemented
        kwargs = kwargs or {}
        if how is _OTHER_OP or K.ANALYSIS.quiet:
            return func(*args, **kwargs)
        counted, functional, composite, flops = how
        if composite:  # as FlopCounterMode: count what it decomposes into
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        key = None
        if functional and self.memo is not None:
            key = (func, _sig(args),
                   _sig(kwargs.items()) if kwargs else None)
            hit = self.memo.get(key)
            if hit is not None:
                spec, f, b = hit
                out = _remake(spec)
                self.flops += f
                self.bytes += b
                self.track(out)
                return out
        out = func(*args, **kwargs)
        f = flops(*args, out_val=out, **kwargs) if flops is not None else 0
        b = _nbytes(args) + _nbytes(_outs(out)) if counted else 0
        self.flops += f
        self.bytes += b
        if functional:
            self.track(out)
            if key is not None:
                spec = _spec(out)
                if spec is not None:
                    self.memo[key] = (spec, f, b)
        return out


# ---------------------------------------------------------------------------
# one rank's inputs and step
# ---------------------------------------------------------------------------


def _fake_mesh(mesh, rank: int):
    """A fake process group of the mesh's size, this process its `rank`,
    and a DeviceMesh over it in launch/mesh.py's rank-major layout."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    axes = mesh_axes(mesh)
    n = 1
    for s in axes.values():
        n *= s
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    return DeviceMesh("cpu", torch.arange(n).reshape(tuple(axes.values())),
                      mesh_dim_names=tuple(axes))


def _dtensors(local, whole, specs, mesh):
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t, w, s: None if t is None else DTensor.from_local(
        t, mesh, rules.placements(s, mesh), run_check=False,
        shape=w.shape, stride=w.stride()), local, whole, specs)


def _rank_inputs(cfg, shape, env, opt):
    """(the step's arguments on the meta device for env's rank, its step,
    the tensors the rank holds). Over a DeviceMesh the state is DTensors
    placed by the rules over the rank's local shards (the sharded train
    step unwraps them), the parameters the rank's shards
    (bridge.rank_shards' cut), the rows the rank's (batch_specs), the
    cache the rank's (init_cache over the mesh)."""
    args, step = St.input_specs(cfg, shape, env, opt)
    if env.mesh is None:
        return args, step, tree_leaves(list(args))
    if shape.kind == "train":
        state, batch = args
        specs = rules.state_specs(state, cfg, env)
        local = rules.local_shards(state, specs, env)
        rows = rules.local_shards(batch, rules.batch_specs(
            batch, cfg, shape, env), env)
        return ((_dtensors(local, state, specs, env.mesh), rows), step,
                tree_leaves([local, rows]))
    params = rules.local_shards(args[0], Mo.param_specs(cfg, env), env)
    if shape.kind == "prefill":
        batch = args[1]
        rows = rules.local_shards(batch, rules.batch_specs(
            batch, cfg, shape, env), env)
        return (params, rows), step, tree_leaves([params, rows])
    cache = Mo.init_cache(cfg, env, shape.global_batch, shape.seq_len,
                          device="meta")
    tok = torch.empty((Mo._local_rows(shape.global_batch, env), 1),
                      dtype=torch.int32, device="meta")
    cur = args[3]
    return ((params, cache, tok, cur), step,
            tree_leaves([params, cache, tok, cur]))


def run_step(cfg: ModelConfig, shape: ShapeConfig, env: Env, step, args):
    """The cell's step on its arguments, the decode step followed by its
    greedy pick (launch/roofline.py count_step counts both)."""
    out = step(*args)
    if shape.kind == "decode":
        St.greedy(out[0], cfg, env)
    return out


def measure(fn, args) -> StepCost:
    """Run fn() once under a meter over `args` (the tensors held before
    it runs) and the collective counters, on the meta device or the
    card: its StepCost without units, coll.by_axis keyed by (type,
    process group name) (measure_step names the groups' mesh axes)."""
    args = [x for x in args if isinstance(x, torch.Tensor)]
    m = _Meter(args)
    C.collective_bytes(reset=True)
    t0 = time.perf_counter()
    if K.ANALYSIS.sink is not None:
        raise RuntimeError("a step analysis is already active")
    K.ANALYSIS.sink = m.kernel
    try:
        with m:
            out = fn()
        del out
    finally:
        K.ANALYSIS.sink = None
    seconds = time.perf_counter() - t0
    cost = StepCost(flops=m.flops, args_bytes=tree_bytes(args),
                    temp_bytes=m.peak, bytes_accessed=m.bytes,
                    kernel_flops=m.kernel_flops, seconds=seconds)
    by_group = C.group_bytes()
    for kind, n in C.collective_bytes(reset=True).items():
        if n:
            cost.coll.by_type[kind] = n
    for (kind, group), n in by_group.items():
        cost.coll.by_axis[(kind, group)] = n
    return cost


def _name_axes(cost: StepCost, mesh):
    """Replace the process-group names of cost.coll.by_axis by the mesh
    axes they are the groups of."""
    names = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
    by_axis = {}
    for (kind, g), n in cost.coll.by_axis.items():
        key = (kind, names.get(g, g))
        by_axis[key] = by_axis.get(key, 0) + n
    cost.coll.by_axis = by_axis


def _measure_once(cfg, shape, env, opt) -> StepCost:
    args, step, held = _rank_inputs(cfg, shape, env, opt)
    cost = measure(lambda: run_step(cfg, shape, env, step, args), held)
    if env.mesh is not None:
        _name_axes(cost, env.mesh)
    return cost


def _depth(cfg: ModelConfig, blocks: int, enc: Optional[int] = None):
    """cfg cut to `blocks` units of its block pattern (its tail kept) and,
    for an encoder-decoder, `enc` encoder layers."""
    kw = {"n_layers": blocks * len(cfg.block_pattern)
          + len(cfg.pattern_tail)}
    if enc is not None:
        kw["encoder_layers"] = enc
    return dataclasses.replace(cfg, **kw)


def unit_runs(cfg: ModelConfig, shape: ShapeConfig, env: Env,
              opt: Optional[AdamWConfig] = None):
    """Yield (segment, trip, make) for each repeating segment of the step
    (the JAX package's _unit_lowerings: "main", the block pattern over
    num_blocks; "enc", an encoder-decoder's encoder layers outside
    decode): make() measures one unit's flops, the flops one more unit
    adds to the step (the step at two units less the step at one, every
    other segment at one unit). Nothing runs until make() is called."""
    opt = opt or AdamWConfig()
    segs = [("main", cfg.num_blocks)]
    if cfg.is_encdec and shape.kind != "decode":
        segs.append(("enc", cfg.encoder_layers))
    enc1 = 1 if cfg.is_encdec else None

    for name, trip in segs:
        def make(name=name):
            if name == "main":
                two, one = _depth(cfg, 2, enc1), _depth(cfg, 1, enc1)
            else:
                two, one = _depth(cfg, 1, 2), _depth(cfg, 1, 1)
            return (_measure_once(two, shape, env, opt).flops
                    - _measure_once(one, shape, env, opt).flops)
        yield name, trip, make


def measure_step(cfg: ModelConfig, shape: ShapeConfig, env: Env,
                 opt: Optional[AdamWConfig] = None, *, units: bool = True,
                 rank: int = 0) -> StepCost:
    """The StepCost of a cell's step (launch/steps.py input_specs: the
    train, prefill or decode step of shape.kind; decode with its greedy
    pick) for one rank of env.mesh (a shape-only mesh, launch/mesh.py
    make_production_mesh(abstract=True), or None for one device), run
    once on the meta device. Over a mesh it runs inside a fake process
    group of the mesh's size (see the module docstring), destroyed after;
    it refuses to run inside a process group already initialised. rank:
    the rank whose shards and groups it runs (the fake group's own rank
    is 0). units: the per-segment report (unit_runs)."""
    opt = opt or AdamWConfig()
    if env.mesh is None:
        return _with_units(_measure_once(cfg, shape, env, opt), cfg, shape,
                           env, opt, units)
    if dist.is_initialized():
        raise RuntimeError(
            "measure_step runs a fake process group of the mesh's size and "
            "refuses to replace the process group already initialised")
    with warnings.catch_warnings():
        # the collectives' deprecated names (all_gather_into_tensor,
        # reduce_scatter_tensor) warn once a call
        warnings.simplefilter("ignore", FutureWarning)
        mesh = _fake_mesh(env.mesh, rank)
        try:
            renv = Env(plan=env.plan, mesh=mesh)
            cost = _with_units(_measure_once(cfg, shape, renv, opt), cfg,
                               shape, renv, opt, units)
        finally:
            dist.destroy_process_group()
    return cost


def _with_units(cost, cfg, shape, env, opt, units):
    if units:
        t0 = time.perf_counter()
        for name, trip, make in unit_runs(cfg, shape, env, opt):
            cost.units.append({"segment": name, "trip": trip,
                               "unit_flops": make()})
        cost.seconds += time.perf_counter() - t0
    return cost
