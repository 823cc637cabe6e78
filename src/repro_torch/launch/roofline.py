"""The roofline of a cell on the H100 (port of the JAX package's
launch/roofline.py and the roofline half of launch/hlo_analysis.py).

The JAX package compiles a cell's step for 256 or 512 forced host
devices and reads its flops from XLA's cost analysis and its collective
bytes from the HLO text. The port reads both from the step it executes,
run once for one rank on the meta device (launch/step_analysis.py
measure_step); analyze() takes its terms from that measurement and puts
beside them an analytic count (count_step) from the config, the plan and
the mesh's axis sizes, walking the code path the port's step runs per
rank (models/model.py: one device, or _Ranks over a mesh; models/moe.py;
parallel/collectives.py; launch/steps.py):

- flops: every matrix product the step executes (a contraction: the
  linears, the attention scores and P.V, the MoE experts and router,
  Griffin's block-diagonal gates, RWKV's decay LoRA and the WKV
  readout), with the padding it executes (whole ROW_TILE-row tiles of
  every sequence or decode batch, padded heads and vocabulary, each
  expert's capacity, masked attention blocks: the plain versions compute
  the whole score matrix, as the reference's XLA path does; the kernels
  on the card skip masked tiles, so there the attention count is an
  upper bound). A train step adds the backward (two products per
  product) and the recompute of each checkpointed unit under remat.
  Elementwise work (norms, rope, softmax, the recurrences' scans, the
  depthwise conv, the optimizer) is not counted.
- collective bytes by type (all-gather, reduce-scatter, all-reduce,
  all-to-all), each collective's result bytes on one device, as the JAX
  package's parse_collectives counts them: the FSDP gathers (again in a
  checkpointed unit's recompute) and their f32 reduce-scatters, the TP
  sums and sequence-parallel gathers and reduce-scatters, the
  vocabulary-parallel loss and argmax, the MoE all-to-alls, the
  seq_sharded layout's gather of q and merge, the gradient sync and the
  optimizer's norm. A collective over an axis of one rank counts: the
  port issues it (parallel/collectives.py). tests/test_torch_dryrun.py
  holds the flops to torch.utils.flop_counter.FlopCounterMode over the
  port's own step and the bytes to what parallel/collectives.py counts
  over gloo ranks; tests/test_torch_step_cells_*.py hold the count
  equal to the measured step on every cell over both production meshes.

The rates are the H100 SXM's (H100 below, with their sources). A
collective's time follows the JAX package's ring model (an all-reduce
moves twice its result bytes, the others once) over the fabric its mesh
axis rides: ranks are laid out rank-major (launch/mesh.py: rank r at row
r // model, column r % model) on 8-GPU NVLink nodes, so an axis whose
ranks lie within one node (its stride times its size at most 8, and its
size dividing 8) takes NVLink, and every other axis the 400 Gb/s NDR
link of each GPU. On the production meshes the 16-wide "model" axis
spans two nodes, so every axis there crosses nodes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import (ModelConfig, ParallelPlan, ShapeConfig,
                                      default_plan)
from repro_torch.models import layers as L
from repro_torch.models import model as Mo
from repro_torch.models.env import Env, head_pad, mesh_axes, out_dims
from repro_torch.models.moe import _capacity
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import rules

# The card's rates: NVIDIA H100 Tensor Core GPU data sheet, the SXM5 80 GB
# column (dense figures, no sparsity); NVLink 4 and ConnectX-7 NDR
# InfiniBand as a DGX H100 / HGX H100 node wires them.
H100 = {
    "name": "NVIDIA H100 SXM5 80GB",
    "power_limit_w": 700,  # the data sheet's rates assume it
    "bf16_flops": 989e12,  # bf16 tensor-core peak, dense
    "hbm_bytes_per_s": 3.35e12,  # HBM3
    "hbm_bytes": 80e9,
    # NVLink: 900 GB/s a GPU, both directions together, to the other GPUs
    # of its 8-GPU node (NVSwitch); a ring moves one direction's 450 GB/s
    "nvlink_bytes_per_s": 450e9,
    "node_gpus": 8,
    # between nodes: one 400 Gb/s NDR port a GPU, 50 GB/s each way
    "network_bytes_per_s": 50e9,
    "source": ("NVIDIA H100 Tensor Core GPU data sheet (H100 SXM: 989 "
               "TFLOP/s bf16 dense, 3.35 TB/s HBM3, 80 GB, NVLink 900 "
               "GB/s); DGX H100 node: 8 GPUs on NVSwitch, one ConnectX-7 "
               "400 Gb/s NDR port a GPU"),
}

def axis_fabric(axes: Dict[str, int], rates=H100) -> Dict[str, str]:
    """"nvlink" or "network" for each axis of a mesh (name -> size, in
    mesh order), laid out rank-major over nodes of rates["node_gpus"]."""
    out, stride = {}, 1
    names = list(axes)
    for name in reversed(names):
        size = axes[name]
        inside = (size * stride <= rates["node_gpus"]
                  and rates["node_gpus"] % (size * stride) == 0)
        out[name] = "nvlink" if inside else "network"
        stride *= size
    return {n: out[n] for n in names}


@dataclass
class CollectiveStats:
    """Per-device collective result bytes: by type (the JAX package's
    CollectiveStats) and by (type, mesh axis), which the time model
    reads."""
    by_type: Dict[str, float] = field(default_factory=dict)
    by_axis: Dict[Tuple[str, str], float] = field(default_factory=dict)
    count: int = 0

    def add(self, kind: str, nbytes: float, axis: str, times: int = 1):
        if times <= 0:
            return
        self.by_type[kind] = self.by_type.get(kind, 0) + nbytes * times
        key = (kind, axis)
        self.by_axis[key] = self.by_axis.get(key, 0) + nbytes * times
        self.count += times

    def remove(self, kind: str, nbytes: float, axis: str):
        """Take back one collective added before."""
        self.by_type[kind] -= nbytes
        self.by_axis[(kind, axis)] -= nbytes
        self.count -= 1

    def scale(self, kind: str, factor: float):
        """Scale one type's bytes (the int8_ef cross-pod saving)."""
        if kind in self.by_type:
            self.by_type[kind] = int(self.by_type[kind] * factor)
        for key in self.by_axis:
            if key[0] == kind:
                self.by_axis[key] *= factor

    @property
    def total_bytes(self) -> float:
        return sum(self.by_type.values())

    def weighted_time(self, fabric: Dict[str, str], rates=H100) -> float:
        """Ring model: an all-reduce moves twice its bytes, the others
        once, at the rate of the fabric its axis rides."""
        t = 0.0
        for (kind, axis), b in self.by_axis.items():
            bw = (rates["nvlink_bytes_per_s"] if fabric.get(axis) ==
                  "nvlink" else rates["network_bytes_per_s"])
            t += (2.0 if kind == "all-reduce" else 1.0) * b / bw
        return t


@dataclass
class RooflineTerms:
    """The three terms of a step's bound on one device (the JAX package's
    RooflineTerms on the H100's rates)."""
    flops_per_device: float
    hbm_bytes_per_device: float
    coll: CollectiveStats
    n_devices: int
    fabric: Dict[str, str] = field(default_factory=dict)
    rates: Dict[str, Any] = field(default_factory=lambda: H100)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.rates["bf16_flops"]

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / self.rates["hbm_bytes_per_s"]

    @property
    def collective_s(self) -> float:
        return self.coll.weighted_time(self.fabric, self.rates)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def summary(self) -> Dict[str, Any]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": self.coll.total_bytes,
            "collective_by_type": dict(self.coll.by_type),
        }


# ---------------------------------------------------------------------------
# MODEL_FLOPS (useful-flops baseline)
# ---------------------------------------------------------------------------


def model_flops(cfg: ModelConfig, shape: ShapeConfig, env: Env) -> float:
    """6 N per trained token, 2 N per served one; N the unpadded
    parameters, the active ones for an MoE (the JAX package's
    model_flops)."""
    n_total = Mo.count_params(cfg, env, padded=False)
    if cfg.moe is not None:
        # subtract inactive expert params
        expert = cfg.moe.num_experts * 3 * cfg.d_model * cfg.d_ff
        n_layers_moe = cfg.block_pattern.count("moe") * cfg.num_blocks
        inactive = (1 - cfg.moe.top_k / cfg.moe.num_experts)
        n_active = n_total - n_layers_moe * expert * inactive
    else:
        n_active = n_total
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


# ---------------------------------------------------------------------------
# the analytic step count
# ---------------------------------------------------------------------------


def _tiles(n: int) -> int:
    """n rounded up to whole ROW_TILE-row tiles."""
    return -(-n // L.ROW_TILE) * L.ROW_TILE


@dataclass
class StepCount:
    """What one device executes in a cell's step: product flops (forward
    ones in and out of checkpointed units, the total with the backward
    and the recompute) and collective bytes."""
    flops: float = 0.0
    fwd_unit: float = 0.0  # forward flops inside checkpointed units
    fwd_rest: float = 0.0
    coll: CollectiveStats = field(default_factory=CollectiveStats)
    # products the plain versions compute without a matmul op, which
    # FlopCounterMode does not see (the WKV decode step's readout)
    unmatmul: float = 0.0
    # backward products a train step skips (an operand with no gradient)
    no_backward: float = 0.0
    # forward products a checkpointed unit's recompute skips (see
    # _Walk.recompute_stops)
    no_recompute: float = 0.0


class _Walk:
    """One rank's step, walked as models/model.py runs it (see the module
    docstring). Forward flops land in the current bucket; a collective
    issued in the forward is recorded with its train-mode mirror
    (parallel/collectives.py), twice in a checkpointed unit's forward
    (the recompute issues it again)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, env: Env,
                 opt: AdamWConfig, greedy: bool):
        self.cfg, self.shape, self.env, self.opt = cfg, shape, env, opt
        self.mode = shape.kind
        self.train = self.mode == "train"
        self.greedy = greedy
        self.mesh = env.mesh is not None
        self.sizes = mesh_axes(env.mesh) if self.mesh else {}
        self.tp = env.tp
        self.tpa = env.tp_axis
        self.dp = env.dp
        B = shape.global_batch
        # the rank's rows: every row where dp does not divide them
        self.Bl = B if B % max(self.dp, 1) else B // max(self.dp, 1)
        self.params = Mo.meta_params(cfg, env)
        self.specs = (rules.param_specs(self.params, cfg, env) if self.mesh
                      else None)
        self.out = StepCount()
        self.in_unit = False
        self.remat = (self.train and env.plan.remat in ("nothing", "dots"))
        self.whole = Mo.whole_kinds(cfg, self.tp)

    # ---- accounting ---------------------------------------------------------
    def mm(self, flops: float):
        if self.in_unit:
            self.out.fwd_unit += flops
        else:
            self.out.fwd_rest += flops

    def coll(self, kind: str, nbytes: float, axis: str,
             mirror: Optional[Tuple[str, float]] = None):
        """A forward collective (over one axis) and, in train mode, its
        backward mirror (kind, bytes), both on the same axis."""
        fwd = 2 if (self.in_unit and self.remat) else 1
        self.out.coll.add(kind, nbytes, axis, fwd)
        if self.train and mirror is not None:
            self.out.coll.add(mirror[0], mirror[1], axis)

    def gather(self, nbytes_out: float, axis: str, grad_bytes_f32: float):
        """collectives.gather of one axis: all-gather, mirrored by an f32
        reduce-scatter (result: the pre-gather shard in f32)."""
        self.coll("all-gather", nbytes_out, axis,
                  ("reduce-scatter", grad_bytes_f32))

    def sum_axes(self, nbytes: float, axes, train_mirror: bool):
        """collectives.sum_over / all_reduce / mesh_mean over each axis."""
        for a in axes:
            self.coll("all-reduce", nbytes, a,
                      ("all-reduce", nbytes) if train_mirror else None)

    # ---- parameters ---------------------------------------------------------
    def _spec(self, path):
        spec = self.specs
        for k in path:
            spec = spec[k]
        return spec

    def _leaf(self, path):
        x = self.params
        for k in path:
            x = x[k]
        return x

    def local_numel(self, path, kind: str, stacked: bool = True) -> int:
        """A weight's elements in the rank's product: its shard over tp
        (the dp axes gathered by FSDP; a block computed whole gathers tp
        too), per layer for a stacked leaf."""
        x = self._leaf(path)
        shape = tuple(x.shape[1:] if stacked else x.shape)
        n = math.prod(shape)
        if not self.mesh or kind in self.whole:
            return n
        spec = self._spec(path)
        spec = spec[len(spec) - len(shape):]
        for e in spec:
            if self.tpa in rules.axes_of(e):
                n //= self.tp
        return n

    def unshard(self, path, kind: str, stacked: bool = True):
        """_Ranks.unshard of one block: the FSDP gathers (and, for a
        block computed whole, the tp gathers of its rec / mix leaves)."""
        if not self.mesh:
            return
        if not self.env.plan.fsdp and kind not in self.whole:
            return
        dp = set(self.env.dp_axes)
        whole = dp | ({self.tpa} if kind in self.whole else set())

        def one(names, x, sp):
            if "moe" in names and names[-1] != "router":
                return x
            on = whole if names[0] in ("rec", "mix") else dp
            self._gather_leaf(x, sp, on, stacked)
            return x

        rules._tree_map_with_names(one, self._leaf(path), self._spec(path))

    def _gather_leaf(self, x, spec, on, stacked: bool):
        shape = list(x.shape[1:] if stacked else x.shape)
        spec = spec[len(spec) - len(shape):]
        # the rank's shard
        local = list(shape)
        for d, e in enumerate(spec):
            for a in rules.axes_of(e):
                local[d] //= self.sizes[a]
        item = x.element_size()
        for d, e in enumerate(spec):
            axes = tuple(a for a in rules.axes_of(e) if a in on)
            for a in reversed(axes):
                before = math.prod(local)
                local[d] *= self.sizes[a]
                self.gather(math.prod(local) * item, a, before * 4)

    # ---- layers -------------------------------------------------------------
    def run(self) -> StepCount:
        cfg, mode = self.cfg, self.mode
        S = self.shape.seq_len
        if mode == "decode":
            self.decode(S)
        else:
            self.stack(S)
        out = self.out
        fwd = out.fwd_unit + out.fwd_rest
        if self.train:
            recompute = (out.fwd_unit - out.no_recompute if self.remat
                         else 0.0)
            out.flops = 3 * fwd + recompute - out.no_backward
            self.train_tail()
        else:
            out.flops = fwd
        return out

    def rows_of(self, S: int) -> int:
        """Positions of a whole sequence in a sublayer's product: padded
        to whole row tiles at every tp degree (_Ranks)."""
        return _tiles(S)

    def sp_of(self, S: int) -> bool:
        return self.mesh and out_dims(self.env, S)[1] is not None

    def enter(self, rows: int, sp: bool):
        """_Ranks.enter: the whole sequence gathered over tp under
        sequence parallelism (bf16 activations)."""
        if sp:
            d = self.cfg.d_model
            self.gather(rows * d * 2, self.tpa, rows // self.tp * d * 4)

    def row(self, rows: int, split: bool, sp: bool):
        """_Ranks.row over `rows` positions: the f32 shares summed over tp
        (reduce-scattered under sequence parallelism)."""
        if not self.mesh or self.tp == 1 or not split:
            return
        d = self.cfg.d_model
        if sp:
            self.coll("reduce-scatter", rows // self.tp * d * 4, self.tpa,
                      ("all-gather", rows * d * 4))
        else:
            self.coll("all-reduce", rows * d * 4, self.tpa,
                      ("all-reduce", rows * d * 4))

    def linear(self, path, kind: str, rows: int, stacked: bool = True):
        self.mm(2 * rows * self.local_numel(path, kind, stacked))

    def stack(self, S: int):
        """Prefill and train: embed, the encoder, every block, the final
        norm and the unembedding (models/model.py _prefill, _train,
        _stack_ranks)."""
        cfg, Bl = self.cfg, self.Bl
        d = cfg.d_model
        n_tok = S - (cfg.num_vision_embeds if cfg.family == "vlm" else 0)
        if self.mesh and self.tp > 1 and self._on_tp("embed", 1):
            self.gather(Bl * n_tok * d * 2, self.tpa,
                        Bl * n_tok * d // self.tp * 4)
        sp = self.sp_of(S)
        Sx = self.rows_of(S)
        enc = None
        if cfg.is_encdec:
            enc = self.encoder(S // cfg.enc_downsample)
        for i in range(cfg.num_blocks):
            self.in_unit = self.remat
            for j, kind in enumerate(cfg.block_pattern):
                self.block(("blocks", j), kind, S, Sx, sp, enc)
            self.in_unit = False
            if self.remat:
                self.recompute_stops(("blocks", j), kind, S, Sx, sp)
        for j, kind in enumerate(cfg.pattern_tail):
            self.block(("tail", j), kind, S, Sx, sp, enc, stacked=False)
        self.enter(Bl * S, sp)  # the final norm's output, whole
        vp_l = self.local_numel(("unembed",), "", stacked=False)
        if self.mode == "prefill":  # last_only: one row tile a sequence
            t0 = (S - 1) // L.ROW_TILE * L.ROW_TILE
            self.mm(2 * Bl * min(L.ROW_TILE, Sx - t0) * vp_l)
        else:
            self.mm(2 * Bl * Sx * vp_l)
            self.loss(S)

    def _on_tp(self, name: str, dim: int) -> bool:
        spec = self._spec((name,))
        return len(spec) > dim and self.tpa in rules.axes_of(spec[dim])

    def encoder(self, Se: int):
        """_encode: encoder_layers "enc" blocks over the frames, the
        output gathered whole. Returns (its rows, its positions)."""
        sp = self.sp_of(Se)
        Sx = self.rows_of(Se)
        for i in range(self.cfg.encoder_layers):
            self.in_unit = self.remat
            self.block(("enc_blocks", 0), "enc", Se, Sx, sp, None)
            self.in_unit = False
            if self.remat:
                self.recompute_stops(("enc_blocks", 0), "enc", Se, Sx, sp)
        self.enter(self.Bl * Se, sp)
        return (Sx, Se)

    def block(self, path, kind: str, S: int, Sx: int, sp: bool, enc,
              stacked: bool = True):
        cfg, Bl = self.cfg, self.Bl
        R = Bl * Sx
        Rr = Bl * (S if sp else Sx)  # a row product's rows (_Ranks.row)
        self.unshard(path, kind, stacked)
        if kind in ("attn", "local", "moe", "enc", "dec"):
            window = cfg.local_window if kind == "local" else 0
            self.enter(Bl * S, sp)
            for w in ("wq", "wk", "wv", "wo"):
                self.linear(path + ("attn", w), kind, R, stacked)
            self.attention(S, S, window, causal=kind != "enc")
            self.row(Rr, True, sp)
            if kind == "dec":
                e_rows, Se = enc
                self.enter(Bl * S, sp)
                self.linear(path + ("xattn", "wq"), kind, R, stacked)
                self.linear(path + ("xattn", "wo"), kind, R, stacked)
                for w in ("wk", "wv"):
                    self.linear(path + ("xattn", w), kind, Bl * e_rows,
                                stacked)
                self.core(Bl, S, Se)
                self.row(Rr, True, sp)
            if kind == "moe":
                self.moe(path + ("moe",), Bl, S, sp)
            else:
                self.mlp(path + ("mlp",), kind, Bl, S, Sx, sp, stacked)
        elif kind == "rglru":
            self.enter(Bl * S, sp)
            for w in ("w_gate_in", "w_in", "w_rgate", "w_igate", "w_out"):
                self.linear(path + ("rec", w), kind, R, stacked)
            self.row(Rr, self._split(path + ("rec", "w_out"), kind,
                                         stacked), sp)
            self.mlp(path + ("mlp",), kind, Bl, S, Sx, sp, stacked)
        else:  # rwkv
            self.enter(Bl * S, sp)
            for w in ("w_r", "w_k", "w_v", "w_g", "decay_A", "decay_B",
                      "w_o"):
                self.linear(path + ("mix", w), kind, R, stacked)
            H = self._rwkv_heads(kind)
            hd = cfg.head_dim
            if self.train:
                self.wkv_chunked(H, S)
            else:
                self.mm(2 * Bl * H * S * hd * hd)  # the readout r^T S_t
            self.row(Rr, H * hd != cfg.d_model, sp)
            self.enter(Bl * S, sp)  # channel mix
            for w in ("cm_k", "cm_r", "cm_v"):
                self.linear(path + ("mix", w), kind, R, stacked)
            self.row(Rr, self._split(path + ("mix", "cm_v"), kind,
                                         stacked), sp)
            if self.local_numel(path + ("mix", "cm_r"), kind, stacked) \
                    != cfg.d_model ** 2:  # rr's columns gathered
                d = cfg.d_model
                self.gather(R * d * 2, self.tpa, R * d // self.tp * 4)

    def recompute_stops(self, path, kind: str, S: int, Sx: int, sp: bool):
        """torch.utils.checkpoint (non-reentrant) stops a unit's recompute
        once the last tensor its backward saved is recomputed, so what
        the unit's last block runs after that is not run again: the last
        row tile's product of the tp row product closing its MLP (a
        matmul saves its inputs before it runs) and that product's sum or
        reduce-scatter; after an MoE
        layer's combine, its closing gather and the aux loss's mean.
        RWKV's channel mix multiplies after its row: nothing stops
        early."""
        if kind == "rwkv" or not self.mesh:
            return
        d = self.cfg.d_model
        Bl = self.Bl
        if kind == "moe":
            mode = self.env.plan.resolve_moe(self.cfg, self.tp)
            if (mode == "ep" and self.tpa is not None and S % self.tp == 0
                    and not sp):
                self.out.coll.remove("all-gather", Bl * S * d * 2, self.tpa)
            for a in self.env.axis_names:
                self.out.coll.remove("all-reduce", 4, a)
            return
        w = path + ("mlp", "w_down")
        if self.tp == 1 or not self._split(w, kind, True):
            return
        # the product runs tile by tile (layers.linear_f32): the stop
        # spares the last row tile's product only
        rows = Bl * Sx
        last = rows - (_tiles(rows) // L.ROW_TILE - 1) * L.ROW_TILE
        self.out.no_recompute += 2 * last * self.local_numel(w, kind)
        if sp:
            self.out.coll.remove("reduce-scatter", Bl * S // self.tp * d * 4,
                                 self.tpa)
        else:
            self.out.coll.remove("all-reduce", Bl * Sx * d * 4, self.tpa)

    def _split(self, path, kind, stacked) -> bool:
        """Whether a row weight holds this rank's rows."""
        x = self._leaf(path)
        n = math.prod(x.shape[1:] if stacked else x.shape)
        return self.local_numel(path, kind, stacked) != n

    def _rwkv_heads(self, kind) -> int:
        H = self.cfg.n_heads
        return H if (self.tp == 1 or kind in self.whole) else H // self.tp

    def _hq_local(self) -> int:
        return head_pad(self.cfg, self.env) // max(self.tp, 1)

    def core(self, B: int, Sq: int, Sk: int):
        """Scores and P.V over every (query, key) pair: 2 products."""
        self.mm(4 * B * self._hq_local() * Sq * Sk * self.cfg.head_dim)

    def attention(self, S: int, Sk: int, window: int, causal: bool):
        """Self-attention of a prefill or train forward, as dispatched:
        train under xla_chunked past attn_q_chunk in q chunks (every key
        chunk, or the window's span); otherwise the whole S x S matrix
        (attention_naive, or the flash kernel's plain version)."""
        plan = self.env.plan
        if (self.train and plan.attn_impl == "xla_chunked"
                and S > plan.attn_q_chunk):
            qc = plan.attn_q_chunk
            if window > 0:
                self.core(self.Bl, S, qc + window)
                return
            self.core(self.Bl, S, S)
            return
        self.core(self.Bl, S, Sk)

    def mlp(self, path, kind, Bl, S, Sx, sp, stacked):
        self.enter(Bl * S, sp)
        for w in ("w_gate", "w_up", "w_down"):
            self.linear(path + (w,), kind, Bl * Sx, stacked)
        self.row(Bl * (S if sp else Sx),
                 self._split(path + ("w_down",), kind, stacked), sp)

    def moe(self, path, Bl: int, S: int, sp: bool):
        """models/moe.py over the tokens one dispatch holds."""
        cfg, env = self.cfg, self.env
        m = cfg.moe
        E, k, cf = m.num_experts, m.top_k, m.capacity_factor
        d, ff = cfg.d_model, cfg.d_ff
        if not self.mesh:
            n = Bl * S
            cap = _capacity(n, E, k, cf)
            self.mm(2 * n * d * E + 6 * E * cap * d * ff)
            return
        mode = env.plan.resolve_moe(cfg, self.tp)
        tpa = self.tpa
        seq_split = mode == "ep" and tpa is not None and S % self.tp == 0
        if sp and not seq_split:  # tp mode: every position
            self.gather(Bl * S * d * 2, tpa, Bl * S // self.tp * d * 4)
        n = Bl * (S // self.tp if seq_split else S)
        cap = _capacity(n, E, k, cf)
        # _gather_fsdp of the expert weights
        dp = set(env.dp_axes)
        for w in ("w_gate", "w_up", "w_down"):
            self._gather_leaf(self._leaf(path + (w,)),
                              self._spec(path + (w,)), dp, True)
        self.mm(2 * n * d * E)  # the router, f32
        ff_l = self.local_numel(path + ("w_gate",), "moe") // (E * d) \
            if mode != "ep" else ff
        self.mm(6 * E * cap * d * ff_l)
        if mode == "ep" and tpa is not None:
            b = E * cap * d * 2
            for _ in range(2):
                self.coll("all-to-all", b, tpa, ("all-to-all", b))
        elif self.tp > 1 and ff_l != ff:
            b = E * cap * d * 4
            self.coll("all-reduce", b, tpa, ("all-reduce", b))
        if seq_split and not sp:
            self.gather(Bl * S * d * 2, tpa, Bl * S // self.tp * d * 4)
        self.sum_axes(4, env.axis_names, train_mirror=True)  # mesh_mean(aux)

    def wkv_chunked(self, H: int, S: int):
        """rwkv_time_mix_chunked's products over whole chunks (train
        mode): the intra-chunk scores and their P.V, the bonus term, the
        carried state's readout and update."""
        Bl, hd = self.Bl, self.cfg.head_dim
        c = min(self.env.plan.rwkv_chunk, S)
        n = S // c
        state = 2 * Bl * c * H * hd * hd
        per_chunk = (2 * Bl * H * c * c * hd * 2  # A = r k D, o = A v
                     + 2 * Bl * c * H * hd  # Au
                     + 2 * state)  # rP st, kT^T v
        self.mm(n * per_chunk)
        # no gradient through the first chunk's zero state, none for the
        # final state's update (the loss does not read it)
        self.out.no_backward += 3 * state

    def loss(self, S: int):
        """lm_loss per rank: the vocabulary-parallel log-sum-exp and label
        logit (tp > 1), the loss's and ce's means over the mesh."""
        if not self.mesh:
            return
        cfg = self.cfg
        St = S - (cfg.num_vision_embeds if cfg.family == "vlm" else 0)
        if self.tp > 1:
            b = self.Bl * St * 4
            self.coll("all-reduce", b, self.tpa)  # the max, no gradient
            for _ in range(2):  # the exponentials' sum, the label logit
                self.coll("all-reduce", b, self.tpa, ("all-reduce", b))
        self.sum_axes(4, self.env.axis_names, train_mirror=False)  # loss
        self.sum_axes(4, self.env.axis_names, train_mirror=False)  # ce

    def train_tail(self):
        """launch/steps.py sync_grads and AdamW's sharded norm (and int8
        row scales) over the mesh."""
        if not self.mesh:
            return
        env = self.env
        leaves = []
        rules._tree_map_with_names(
            lambda names, x, s: leaves.append((x, s)), self.params,
            self.specs)
        for x, spec in leaves:
            on = {a for e in spec for a in rules.axes_of(e)}
            n = x.numel()
            for a in on:
                n //= self.sizes[a]
            for a in env.axis_names:
                if a not in on:
                    self.out.coll.add("all-reduce", n * 4, a)
        for a in env.axis_names:  # global_norm
            self.out.coll.add("all-reduce", len(leaves) * 4, a)
        if self.opt.state_dtype == "int8":
            for x, spec in leaves:
                if x.dim() < 2:
                    continue
                axes = [a for a in rules.axes_of(spec[-1] if spec else None)
                        if a in env.axis_names]
                n = x.numel()
                for e in spec:
                    for a in rules.axes_of(e):
                        n //= self.sizes[a]
                rows = n // (x.shape[-1] // math.prod(
                    self.sizes[a] for a in axes) if axes else x.shape[-1])
                for a in axes:
                    self.out.coll.add("all-reduce", rows * 4, a, 2)

    def decode(self, Smax: int):
        """One contiguous-cache decode step (make_decode_step) per rank,
        and the greedy pick (launch/steps.py greedy)."""
        cfg, env = self.cfg, self.env
        n = self.Bl
        Bp = _tiles(n)
        d = cfg.d_model
        if self.mesh and self.tp > 1 and self._on_tp("embed", 1):
            self.gather(Bp * d * 2, self.tpa, 0)
        kv_seq = self.mesh and env.plan.kv_cache == "seq_sharded"
        hd = cfg.head_dim
        hq_l = self._hq_local()
        hq = head_pad(cfg, env)
        Se = Smax // cfg.enc_downsample if cfg.is_encdec else 0

        def attend(Sc, window):
            if kv_seq and not window:
                self.gather(n * hq * hd * 2, self.tpa, 0)  # q, every head
                self.mm(4 * n * hq * (Sc // self.tp) * hd)
                self.merge(n, hq)
            else:
                self.mm(4 * n * hq_l * Sc * hd)

        def one(path, kind, stacked):
            self.unshard(path, kind, stacked)
            if kind in ("attn", "local", "moe", "dec"):
                window = cfg.local_window if kind == "local" else 0
                for w in ("wq", "wk", "wv", "wo"):
                    self.linear(path + ("attn", w), kind, Bp, stacked)
                attend(min(window, Smax) if window else Smax, window)
                self.row(Bp, True, False)
                if kind == "dec":
                    self.linear(path + ("xattn", "wq"), kind, Bp, stacked)
                    self.linear(path + ("xattn", "wo"), kind, Bp, stacked)
                    if kv_seq:
                        self.gather(n * hq * hd * 2, self.tpa, 0)
                        # _Ranks.cross_len: the rank's encoder positions
                        se_l = Se if Se % self.tp else Se // self.tp
                        self.mm(4 * n * hq * se_l * hd)
                        self.merge(n, hq)
                    else:
                        self.mm(4 * n * hq_l * Se * hd)
                    self.row(Bp, True, False)
                if kind == "moe":
                    self.moe(path + ("moe",), n, 1, False)
                else:
                    self.mlp(path + ("mlp",), kind, Bp, 1, 1, False, stacked)
            elif kind == "rglru":
                for w in ("w_gate_in", "w_in", "w_rgate", "w_igate",
                          "w_out"):
                    self.linear(path + ("rec", w), kind, Bp, stacked)
                self.row(Bp, self._split(path + ("rec", "w_out"), kind,
                                         stacked), False)
                self.mlp(path + ("mlp",), kind, Bp, 1, 1, False, stacked)
            else:  # rwkv
                for w in ("w_r", "w_k", "w_v", "w_g", "decay_A", "decay_B",
                          "w_o", "cm_k", "cm_r", "cm_v"):
                    self.linear(path + ("mix", w), kind, Bp, stacked)
                H = self._rwkv_heads(kind)
                self.out.unmatmul += 2 * n * H * hd * hd  # the readout
                self.row(Bp, H * hd != d, False)
                self.row(Bp, self._split(path + ("mix", "cm_v"), kind,
                                         stacked), False)
                if self.local_numel(path + ("mix", "cm_r"), kind, stacked) \
                        != d * d:
                    self.gather(Bp * d * 2, self.tpa, 0)

        for i in range(cfg.num_blocks):
            for j, kind in enumerate(cfg.block_pattern):
                one(("blocks", j), kind, True)
        for j, kind in enumerate(cfg.pattern_tail):
            one(("tail", j), kind, False)
        self.mm(2 * Bp * self.local_numel(("unembed",), "", stacked=False))
        self.mm(self.out.unmatmul)
        if self.greedy and self.mesh and self.tpa is not None:
            self.out.coll.add("all-gather", self.tp * n * 4, self.tpa)
            self.out.coll.add("all-gather", self.tp * n * 8, self.tpa)

    def merge(self, n: int, hq: int):
        """kernels/flash_decode/ops.py merge_partials over tp: the max of
        m, the sums of the weights and of the weighted partials (f32)."""
        hd = self.cfg.head_dim
        for b in (n * hq * 4, n * hq * 4, n * hq * hd * 4):
            self.coll("all-reduce", b, self.tpa)


def count_step(cfg: ModelConfig, shape: ShapeConfig, env: Env,
               opt: Optional[AdamWConfig] = None, *,
               greedy: bool = True) -> StepCount:
    """The per-device product flops and collective bytes of a cell's step
    (see the module docstring): make_train_step (one AdamW update),
    make_prefill_step (last-position logits) or make_decode_step over a
    contiguous cache of seq_len positions (plus, over a mesh, the greedy
    pick's vocabulary-parallel argmax unless greedy=False)."""
    return _Walk(cfg, shape, env, opt or AdamWConfig(), greedy).run()


def count_moe_layer(cfg: ModelConfig, env: Env, batch: int,
                    seq: int) -> StepCount:
    """One forward moe_layer call (models/moe.py) on a rank's rows of a
    [batch, seq, d] input holding every position: the first MoE block's
    weights, its products and collectives."""
    w = _Walk(cfg, ShapeConfig("moe", seq, batch, "prefill"), env,
              AdamWConfig(), greedy=False)
    j = cfg.block_pattern.index("moe")
    w.moe(("blocks", j, "moe"), w.Bl, seq, False)
    w.out.flops = w.out.fwd_rest
    return w.out


# ---------------------------------------------------------------------------
# cell analysis
# ---------------------------------------------------------------------------


def plan_int8_ef(env: Env) -> bool:
    return (env.plan.grad_compression == "int8_ef"
            and "pod" in env.axis_names)


def measured_agrees(step, count: StepCount) -> bool:
    """Whether a measured step (launch/step_analysis.py StepCost) and the
    analytic count agree: the flops exactly, with the products
    FlopCounterMode cannot see (StepCount.unmatmul) added to the
    measured, and the collective bytes exactly, type by type."""
    nonzero = lambda c: {k: v for k, v in c.by_type.items() if v}
    return (step.flops + count.unmatmul == count.flops
            and nonzero(step.coll) == nonzero(count.coll))


def analyze(cfg: ModelConfig, shape: ShapeConfig, env: Env,
            opt: Optional[AdamWConfig] = None, *, rates=H100,
            capacity_bytes: Optional[float] = None, measure: bool = True,
            units: bool = True) -> Dict[str, Any]:
    """The roofline report of one configuration on env's mesh (None: one
    device): the terms, the model flops, the memory model and the step's
    bounds. The flops and collective terms are the step's own, measured
    (launch/step_analysis.py measure_step: the step run once for one
    rank on the meta device, as the JAX package reads them from its
    compiled step), with the analytic count (count_step) beside them and
    whether the two agree; measure=False: the analytic terms alone. The
    memory term is the memory model's traffic, as in the JAX package.
    units: the measured per-segment report. capacity_bytes: the device's
    memory for the fit (default the rates' HBM; on the card its
    total_memory)."""
    from repro_torch.launch.memory_model import analyze_memory

    if opt is None and cfg.param_count() > 1e11:
        # >=100B params: int8-blockwise moments to fit one pod
        opt = AdamWConfig(state_dtype="int8")
    opt = opt or AdamWConfig()
    count = count_step(cfg, shape, env, opt)
    step, agrees = None, None
    if measure:
        from repro_torch.launch.step_analysis import measure_step
        step = measure_step(cfg, shape, env, opt, units=units)
        agrees = measured_agrees(step, count)
    if plan_int8_ef(env):
        # the JAX package's modeled wire saving for the cross-pod gradient
        # sync at int8 (optim/compress.py); the step itself issues f32
        for c in (count.coll, step.coll if step else None):
            if c is not None:
                c.scale("all-reduce", 0.625)
    opt_bytes = 6.3 if opt.state_dtype == "int8" else 12.0
    memrep = analyze_memory(cfg, shape, env,
                            opt_state_bytes_per_param=opt_bytes)
    axes = mesh_axes(env.mesh) if env.mesh is not None else {}
    n_dev = math.prod(axes.values()) if axes else 1
    fabric = axis_fabric(axes, rates)
    flops = step.flops if step else count.flops
    terms = RooflineTerms(flops_per_device=flops,
                          hbm_bytes_per_device=memrep.traffic_bytes,
                          coll=step.coll if step else count.coll,
                          n_devices=n_dev, fabric=fabric, rates=rates)
    mf = model_flops(cfg, shape, env)
    step_global = flops * n_dev
    cap = capacity_bytes or rates["hbm_bytes"]
    out = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": dict(axes),
        "fabric": fabric,
        "n_devices": int(n_dev),
        **terms.summary(),
        "model_flops_global": mf,
        "step_flops_global": step_global,
        "useful_flops_ratio": mf / step_global if step_global else 0.0,
        "analytic_flops_per_device": count.flops,
        "analytic_flops_global": count.flops * n_dev,
        "analytic_unmatmul_per_device": count.unmatmul,
        "analytic_collective_by_type": dict(count.coll.by_type),
        "analytic_agrees": agrees,
        "memory": {
            "traffic_bytes_per_device": int(memrep.traffic_bytes),
            "resident_bytes_per_device": int(memrep.resident_bytes),
            "components": memrep.components,
            "train_state_bytes_per_device": memrep.train_state(),
            "fits_16GB": memrep.fits_16GB,
            "device_bytes": cap,
            "fits_device": memrep.fits(cap),
        },
        "units": step.units if step else [],
        "dominant": terms.bottleneck,
        # step time bound = max of terms (perfect overlap) / sum (none)
        "step_s_lower": max(terms.compute_s, terms.memory_s,
                            terms.collective_s),
        "step_s_upper": terms.compute_s + terms.memory_s + terms.collective_s,
        "rates": {k: rates[k] for k in ("name", "bf16_flops",
                                        "hbm_bytes_per_s", "source")},
    }
    if step:
        # the measured step's buffers and traffic (the JAX package's
        # xla_cpu_* figures), beside the memory model's
        out["memory"].update(step_args_bytes=step.args_bytes,
                             step_temp_bytes=step.temp_bytes,
                             step_bytes_accessed=step.bytes_accessed)
        out["measure_s"] = step.seconds
    out["roofline_fraction"] = (
        (mf / n_dev / rates["bf16_flops"]) / out["step_s_lower"]
        if out["step_s_lower"] else 0.0)
    return out


def analyze_cell(arch: str, shape_name: str, mesh, *,
                 plan: Optional[ParallelPlan] = None,
                 opt: Optional[AdamWConfig] = None, rates=H100,
                 capacity_bytes: Optional[float] = None,
                 measure: bool = True, units: bool = True
                 ) -> Dict[str, Any]:
    """analyze() of one cell of configs.cells() under its default plan
    (the JAX package's analyze_cell): mesh a shape-only mesh
    (launch/mesh.py make_production_mesh(abstract=True)) or None; the
    step measured over a fake process group of the mesh's size."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    plan = plan or default_plan(cfg, shape)
    out = analyze(cfg, shape, Env(plan=plan, mesh=mesh), opt, rates=rates,
                  capacity_bytes=capacity_bytes, measure=measure,
                  units=units)
    out["arch"], out["shape"] = arch, shape_name
    return out
