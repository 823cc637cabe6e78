"""The port's flash-decoding (kernels/flash_decode) against the JAX package
on the CPU.

Each case makes its inputs with numpy from a seed and hands the same
arrays to both packages. On the CPU the port's ops run the plain versions
(the CUDA kernel runs in tests/test_torch_cuda.py and chip_smoke.py); JAX's
flash_decode_kernel runs in interpret mode at tests/test_kernels.py's
shapes (B 2, Hq 8, Hkv 2, S 512, hd 64, block_k 128) and tolerances: 2e-3
in f32 and 3e-2 in bf16 for o, m and l, 1e-3 for merged partials. An
all-masked slice is held to JAX's partials exactly. A ragged S, which
JAX's kernel refuses (S % block_k), is held to decode_ref alone. The
sequence-sharded op runs over a gloo group of 4 ranks, spawned once as
child processes that import only torch and repro_torch, against JAX's
decode_ref within 1e-3 (tests/test_multidevice.py's bound for 8 shards).
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_no_kernel_device import NoKernelTensor
from repro.kernels.flash_decode.kernel import flash_decode_kernel
from repro.kernels.flash_decode.ops import flash_decode as jax_flash_decode
from repro.kernels.flash_decode.ref import decode_ref as jax_decode_ref
from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                  flash_decode_partials,
                                                  merge_partials_stacked)
from repro_torch.kernels.flash_decode.ref import (decode_ref,
                                                  flash_decode_partials_ref)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
B, HQ, HKV, S, HD = 2, 8, 2, 512, 64
CURS = [0, 17, 255, 511]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-3),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(seed, shape_q, shape_kv, dtype):
    """(JAX arrays, torch tensors) holding the same values in `dtype`."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (shape_q, shape_kv, shape_kv)]
    j = [jnp.asarray(a).astype(jdt) for a in arrs]
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
         for x in j]
    return j, t


def _maxdiff(a, b):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        jnp.asarray(a).astype(jnp.float32))
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(
        jnp.asarray(b).astype(jnp.float32))
    return float(np.abs(a - b).max())


@pytest.mark.parametrize("cur", CURS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_partials_match_the_jax_kernel(cur, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(cur, (B, HQ, HD), (B, HKV, S, HD),
                                      dtype)
    jo, jm, jl = flash_decode_kernel(jq, jk, jv, cur, block_k=128,
                                     interpret=True)
    o, m, l = flash_decode_partials_ref(q, k, v, cur)
    assert o.shape == (B, HQ, HD) and m.shape == l.shape == (B, HQ, 1)
    assert o.dtype == m.dtype == l.dtype == torch.float32
    tol = DTYPES[dtype][2]
    for mine, ref in ((o, jo), (m, jm), (l, jl)):
        assert _maxdiff(mine, ref) < tol
    # the op's CPU path is this plain version
    for mine, ref in zip(flash_decode_partials(q, k, v, cur), (o, m, l)):
        assert torch.equal(mine, ref)


@pytest.mark.parametrize("cur", CURS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_op_matches_the_jax_op(cur, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(100 + cur, (B, HQ, HD),
                                      (B, HKV, S, HD), dtype)
    want = jax_flash_decode(jq, jk, jv, cur, block_k=128, interpret=True)
    got = flash_decode(q, k, v, torch.tensor([cur], dtype=torch.int32))
    assert got.dtype == q.dtype and got.shape == (B, HQ, HD)
    assert _maxdiff(got, want) < DTYPES[dtype][2]
    assert _maxdiff(decode_ref(q, k, v, cur),
                    jax_decode_ref(jq, jk, jv, cur)) < DTYPES[dtype][2]


def test_two_half_cache_partials_merge_to_the_whole():
    """tests/test_kernels.py's merge identity: B 1, Hq 4, Hkv 2, S 256,
    hd 32, two halves at local length 127 each."""
    (jq, jk, jv), (q, k, v) = _inputs(7, (1, 4, 32), (1, 2, 256, 32), "f32")
    halves = [flash_decode_partials(q, k[:, :, i:i + 128].contiguous(),
                                    v[:, :, i:i + 128].contiguous(), 127)
              for i in (0, 128)]
    merged = merge_partials_stacked(*(torch.stack(x) for x in zip(*halves)))
    assert _maxdiff(merged, jax_decode_ref(jq, jk, jv, 255)) < 1e-3


def test_all_masked_slice_equals_the_jax_partials():
    (jq, jk, jv), (q, k, v) = _inputs(3, (B, HQ, HD), (B, HKV, S, HD), "f32")
    jo, jm, jl = flash_decode_kernel(jq, jk, jv, -1, block_k=128,
                                     interpret=True)
    o, m, l = flash_decode_partials(q, k, v, -1)
    for mine, ref in ((o, jo), (m, jm), (l, jl)):
        assert np.array_equal(mine.numpy(), np.asarray(ref))
    assert bool((m == np.float32(-1e30)).all()) and not bool(l.any())
    assert not bool(o.any())
    # a masked slice weighs nothing in a merge
    o2, m2, l2 = flash_decode_partials(q, k, v, 300)
    merged = merge_partials_stacked(torch.stack([o, o2]),
                                    torch.stack([m, m2]),
                                    torch.stack([l, l2]))
    assert torch.equal(merged, o2)


def test_ragged_length_is_refused_by_jax_and_taken_by_the_port():
    """S = 700 is no multiple of JAX's block_k: its kernel asserts; the
    port's op takes it and matches decode_ref."""
    (jq, jk, jv), (q, k, v) = _inputs(700, (B, HQ, HD), (B, HKV, 700, HD),
                                      "f32")
    with pytest.raises(AssertionError):
        flash_decode_kernel(jq, jk, jv, 650, block_k=128, interpret=True)
    for cur in (0, 650, 699):
        assert _maxdiff(flash_decode(q, k, v, cur),
                        jax_decode_ref(jq, jk, jv, cur)) < 2e-3


def test_op_raises_on_a_device_with_no_kernel():
    """A device other than the CPU, the card and meta (the dry run's
    shapes) has no kernel: the op raises."""
    q = NoKernelTensor((1, 2, 8), torch.float32)
    kv = NoKernelTensor((1, 1, 16, 8), torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        flash_decode_partials(q, kv, kv, 3)


_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.kernels.flash_decode.ops import flash_decode_seq_sharded

rank, world, store, data = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
z = np.load(data)
q, k, v = (torch.from_numpy(z[n]) for n in ("q", "k", "v"))
s_local = k.shape[2] // world
sl = slice(rank * s_local, (rank + 1) * s_local)
outs = [flash_decode_seq_sharded(q, k[:, :, sl].contiguous(),
                                 v[:, :, sl].contiguous(), int(cur)).numpy()
        for cur in z["curs"]]
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules), "a rank imported jax or repro"
if rank == 0:
    np.save(data + ".out.npy", np.stack(outs))
dist.destroy_process_group()
"""


def test_seq_sharded_over_four_gloo_ranks(tmp_path):
    """tests/test_multidevice.py's seq-sharded merge: B 2, Hq 8, Hkv 2,
    S 512, hd 32, cur 0/100/400/511, over 4 ranks of 128 positions."""
    world, curs = 4, np.asarray([0, 100, 400, 511])
    (jq, jk, jv), (q, k, v) = _inputs(11, (2, 8, 32), (2, 2, 512, 32), "f32")
    data = str(tmp_path / "inputs.npz")
    np.savez(data, q=q.numpy(), k=k.numpy(), v=v.numpy(), curs=curs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANK), str(r), str(world),
         str(tmp_path / "store"), data], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = np.load(data + ".out.npy")
    for i, cur in enumerate(curs):
        assert _maxdiff(torch.from_numpy(got[i]),
                        jax_decode_ref(jq, jk, jv, int(cur))) < 1e-3, cur
