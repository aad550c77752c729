"""The probes P1 (texel gather, ops/texfetch.py) and P2 (dependent-load
chain, tools/exp_extract_cost.py) of the port against the JAX probes'
Pallas kernels, run in interpret mode.

The Pallas kernel bodies are nested inside the JAX tools' main(), so this
file carries a copy of each (tools/exp_gather.py:88-89, the `dgather`
call :92-107; tools/exp_extract_cost.py:62-95, the call :99-105), at small
sizes: P1 on a 256-entry table with 32,768 indices, P2 on 64 table rows
and 32 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from project3_cuda_path_tracer_tpu_torch.ops import texfetch as P1
from project3_cuda_path_tracer_tpu_torch.tools import exp_extract_cost as P2
from project3_cuda_path_tracer_tpu_torch.tools import exp_gather
from project3_cuda_path_tracer_tpu_torch.utils.launches import launch_counts

LANES = 128


def _jax_dgather(flat_u32: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """tools/exp_gather.py's dgather: rows of the lane-replicated [P, 128]
    table, one grid step per P*128 indices."""
    P = flat_u32.shape[0]
    table = jnp.broadcast_to(jnp.asarray(flat_u32)[:, None], (P, LANES))
    chunk = P * LANES
    n = idx.shape[0]
    n_pad = ((n + chunk - 1) // chunk) * chunk
    idx_pad = jnp.concatenate([jnp.asarray(idx),
                               jnp.zeros((n_pad - n,), jnp.int32)]
                              ).reshape(-1, LANES)

    def kernel(tab_ref, idx_ref, out_ref):
        out_ref[:] = jnp.take_along_axis(tab_ref[:], idx_ref[:], axis=0)

    out = pl.pallas_call(
        kernel,
        grid=(n_pad // chunk,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec((P, LANES), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((P, LANES), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n_pad // LANES, LANES), jnp.uint32),
        interpret=True,
    )(table, idx_pad)
    return np.asarray(out).reshape(-1)[:n]


def test_gather_plain_matches_pallas_dgather():
    """P = 256, N = 32,768 random indices: equal bit for bit."""
    rng = np.random.default_rng(0)
    flat = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, 256, 32768).astype(np.int32)
    want = _jax_dgather(flat, idx)
    got = P1.gather(torch.from_numpy(flat.view(np.int32)).view(torch.uint32),
                    torch.from_numpy(idx))
    assert got.dtype == torch.uint32 and got.shape == (32768,)
    np.testing.assert_array_equal(got.view(torch.int32).numpy().view(
        np.uint32), want)
    assert launch_counts()["p1"] == 0


def test_gather_keeps_index_shape_and_checks_inputs():
    table = torch.arange(10, dtype=torch.int32)
    idx = torch.tensor([[3, 1], [9, 0]], dtype=torch.int32)
    assert P1.gather(table, idx).tolist() == [[3, 1], [9, 0]]
    with pytest.raises(TypeError):
        P1.gather(table.float(), idx)
    with pytest.raises(TypeError):
        P1.gather(table, idx.long())
    with pytest.raises(ValueError):
        P1.gather(table[::2], idx)


def _jax_extract(kind: str, table: np.ndarray, state0: np.ndarray,
                 steps: int) -> np.ndarray:
    """tools/exp_extract_cost.py's make(kind), with its ROWS and STEPS
    taken from the table and `steps`."""
    rows = table.shape[0]

    def kernel(tab_ref, st_ref, out_ref):
        st = st_ref[:]

        def body(carry):
            step, idx, st = carry
            row = tab_ref[idx]
            if kind == "extract48":
                acc = st
                for c in range(8):
                    for j in range(6):
                        acc = acc * 0.999 + row[6 * c + j]
                st = acc
            elif kind == "extract6":
                acc = st
                for j in range(6):
                    acc = acc * 0.999 + row[j]
                st = acc
            else:  # vector8
                v = row[:72].reshape(8, 9)
                a = st[:8] * 0.999 + v[:, 0:1]
                for j in range(1, 6):
                    a = a * 0.999 + v[:, j:j + 1]
                st = st.at[:8].set(a)
            nxt = (jnp.sum(st[0:1]).astype(jnp.int32) + step) % rows
            return step + 1, jnp.maximum(nxt, 0), st

        def cond(carry):
            return carry[0] < steps

        _, _, st = jax.lax.while_loop(cond, body,
                                      (jnp.int32(0), jnp.int32(0), st))
        out_ref[:] = st

    return np.asarray(pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((P2.SUB, P2.LANES), jnp.float32),
        interpret=True,
    )(jnp.asarray(table), jnp.asarray(state0)))


@pytest.mark.parametrize("kind", list(P2.KINDS))
def test_extract_cost_plain_matches_pallas(kind):
    """64 rows, 32 steps, the probe's input distributions.

    XLA on the CPU contracts the fold acc * 0.999 + x into one fused
    multiply-add (a one-step model of the fold as an FMA equals the
    interpret-mode kernel bit for bit), while the port rounds the product
    and the sum apart, as torch's separate ops and the CUDA kernel do; the
    lane sum's order differs too. So the states differ by accumulated
    rounding: 3.0e-6 relative at most after 32 steps (extract48, this
    seed), held to 1e-5. A flipped row index would move them by ~1e-3
    relative (a row value differs by ~0.5 on a state of ~170), so equal
    row sequences are what the tolerance checks."""
    table, state = P2.inputs(rows=64, seed=0, device="cpu")
    want = _jax_extract(kind, table.numpy(), state.numpy(), 32)
    got = P2.extract_cost(table, state, kind, 32)
    assert got.shape == (16, 128) and P2.LAUNCHES == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    if kind == "vector8":
        np.testing.assert_array_equal(got[8:].numpy(), state[8:].numpy())


def test_extract_cost_rejects_bad_inputs():
    table, state = P2.inputs(rows=8, device="cpu")
    with pytest.raises(ValueError):
        P2.extract_cost(table, state, "extract7", 1)
    with pytest.raises(ValueError):
        P2.extract_cost(table[:, :9].contiguous(), state, "extract6", 1)
    with pytest.raises(ValueError):
        P2.extract_cost(table, state[:8].contiguous(), "extract6", 1)


def test_lane_sum_is_the_halving_tree():
    x = torch.from_numpy(np.random.default_rng(1).random(128, np.float32)
                         * 1e3)
    want = x.clone()
    h = 64
    while h:
        want = torch.stack([want[i] + want[i + h] for i in range(h)])
        h //= 2
    assert torch.equal(P2._lane_sum(x), want[0])


@pytest.mark.parametrize("table_bytes,k", [(64 << 10, 1), (256 << 10, 0),
                                           (512 << 10, 0), (4 << 20, 0)])
def test_instance_is_picked_by_table_size(table_bytes, k):
    """The probe's 64 KB and 256 KB atlases, sky.hdr's 512 KB and a 4 MB
    table: the block instance while one block's shared memory holds the
    table, the L2 instance above."""
    assert P1.instance_for(table_bytes) == k
    texels = table_bytes // 4
    assert (P1.slice_bytes(texels, 1) <= P1.SLICE_BYTES) == (k == 1)
    assert P1.slice_bytes(texels, 0) == 0


def test_slices_cover_the_table_on_16_byte_bounds():
    for texels in (1, 5, 16384, 65536, 65537, 131072):
        words = P1.slice_bytes(texels, 1) // 4
        assert words % 4 == 0 and words >= texels and words - 4 < texels


def _warp_order_sum(x: np.ndarray) -> np.float32:
    """csrc/extract_cost.cu's row-0 sum: lane l holds columns l, l+32,
    l+64, l+96, adds (a0 + a2) + (a1 + a3) in registers, then five xor
    butterflies (lane l adds lane l ^ h, h = 16 ... 1); lane 0's value."""
    a = x.reshape(4, 32)
    s = (a[0] + a[2]) + (a[1] + a[3])
    lanes = np.arange(32)
    for h in (16, 8, 4, 2, 1):
        s = s + s[lanes ^ h]
        assert s.dtype == np.float32
    assert (s == s[0]).all()  # every lane holds the sum
    return s[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_order_is_the_halving_tree(seed):
    """On float32 data whose sum depends on the order of the additions
    (signed, magnitudes from 1e-3 to 1e7), the kernel's warp order equals
    `_lane_sum` bit for bit, where a sequential sum does not."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(128).astype(np.float32)
         * np.float32(10.0) ** rng.integers(-3, 8, 128)).astype(np.float32)
    tree = P2._lane_sum(torch.from_numpy(x)).numpy()
    assert _warp_order_sum(x).view(np.int32) == tree.view(np.int32)
    others = set()
    for order in (x, x[::-1]):  # left to right, right to left
        s = np.float32(0)
        for v in order:
            s = np.float32(s + v)
        others.add(float(s))
    assert others - {float(tree)}


def test_gather_plain_matches_numpy_at_sky_size():
    """The 512 KB sky table (131,072 texels) with 1M indices."""
    table, _, idx = exp_gather.inputs(exp_gather.SKY, n=1 << 20,
                                      device="cpu")
    assert table.numel() == 131072
    flat = table.view(torch.int32).numpy().view(np.uint32)
    got = P1.gather(table, idx)
    np.testing.assert_array_equal(
        got.view(torch.int32).numpy().view(np.uint32), flat[idx.numpy()])


@pytest.mark.parametrize("kind", list(P2.KINDS))
def test_extract_cost_plain_gives_the_full_loop_state(kind):
    """The plain version at the probe's 4,096 steps gives the state whose
    SHA-256 the card tests hold the kernel to."""
    table, state = P2.inputs(device="cpu")
    out = P2.extract_cost(table, state, kind, P2.STEPS)
    assert P2.sha256(out) == P2.SHA256_STEPS[kind]


def test_chain_floor_adds_its_terms():
    terms = {"chase_ns": 300.0, "fop_ns": 2.0, "shfl_ns": 10.0}
    # the chase, 2K + 1 more FP32 operations, 4 more shuffles
    assert P2.chain_floor_ns(terms, "extract6") == 300 + 13 * 2 + 4 * 10
    assert P2.chain_floor_ns(terms, "extract48") == 300 + 97 * 2 + 4 * 10
    assert P2.chain_floor_ns(terms, "vector8") == \
        P2.chain_floor_ns(terms, "extract6")


def test_gather_instances_need_cuda_tensors():
    table = torch.arange(10, dtype=torch.int32)
    idx = torch.tensor([3, 1], dtype=torch.int32)
    for k in P1.INSTANCES:
        with pytest.raises(ValueError):
            P1._gather_instance(k, table, idx)
    for k in (2, 3, 4):
        with pytest.raises(ValueError, match="instance must be one of"):
            P1._gather_instance(k, table, idx)
    assert launch_counts()["p1_ab"] == 0
