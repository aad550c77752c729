"""ops/compact.py of the torch port against the JAX package's, exactly.

Every function gets the same seeded numpy inputs in both packages: alive
masks (mixed, all dead, all alive), hit distances with misses, material
ids. The permutations must be equal element for element (the port's
stable sort against JAX's stable partition, argsort and counting sort), and
so must the keys, the bucket ids and the permuted trees.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu.ops import compact as JC
from project3_cuda_path_tracer_tpu_torch.ops import compact as PC
from project3_cuda_path_tracer_tpu_torch.ops import wavefront as wf
from project3_cuda_path_tracer_tpu_torch.ops.vec import V3

N, NUM_M = 1000, 7
CASES = ["mixed", "all dead", "all alive", "all miss"]


def _inputs(case: str, seed: int = 0):
    """(alive, hit_t, mat_id) as numpy: `mixed` has ~40% dead lanes and
    ~20% misses (t = -1)."""
    rng = np.random.default_rng(seed)
    alive = rng.random(N) < 0.6
    if case == "all dead":
        alive[:] = False
    elif case == "all alive":
        alive[:] = True
    hit_t = np.where(rng.random(N) < 0.2, -1.0,
                     rng.random(N) * 10).astype(np.float32)
    if case == "all miss":
        hit_t[:] = -1.0
    mat_id = rng.integers(0, NUM_M, N).astype(np.int32)
    return alive, hit_t, mat_id


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("case", CASES)
def test_compaction_permutation_matches_jax(case):
    alive, _, _ = _inputs(case)
    want, want_live = JC.compaction_permutation(jnp.asarray(alive))
    got, got_live = PC.compaction_permutation(_t(alive))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got_live) == int(want_live) == int(alive.sum())


@pytest.mark.parametrize("case", CASES)
def test_sort_key_and_permutation_match_jax(case):
    alive, hit_t, mat_id = _inputs(case, seed=1)
    want = JC.material_sort_key(jnp.asarray(alive), jnp.asarray(hit_t),
                                jnp.asarray(mat_id))
    got = PC.material_sort_key(_t(alive), _t(hit_t), _t(mat_id))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        PC.sort_permutation(got).numpy(),
        np.asarray(JC.sort_permutation(want)))
    assert (PC.DEAD_KEY, PC.MISS_KEY) == (int(JC.DEAD_KEY),
                                          int(JC.MISS_KEY))


@pytest.mark.parametrize("case", CASES)
def test_bucket_sort_matches_jax_counting_sort(case):
    """The stable sort of the bucket ids is the JAX counting sort's
    permutation: live hits by material, live misses, dead lanes."""
    alive, hit_t, mat_id = _inputs(case, seed=2)
    ids_j, nb_j = JC.material_bucket_ids(jnp.asarray(alive),
                                         jnp.asarray(hit_t),
                                         jnp.asarray(mat_id), NUM_M)
    ids_p, nb_p = PC.material_bucket_ids(_t(alive), _t(hit_t),
                                         _t(mat_id), NUM_M)
    assert nb_p == nb_j == NUM_M + 2
    np.testing.assert_array_equal(ids_p.numpy(), np.asarray(ids_j))
    want = np.asarray(JC.bucket_sort_permutation(ids_j, nb_j))
    got = PC.bucket_sort_permutation(ids_p, nb_p).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.argsort(ids_p.numpy(),
                                                  kind="stable"))
    # live lanes first, the dead ones last in lane order
    n_live = int(alive.sum())
    assert (~alive[got[n_live:]]).all() and alive[got[:n_live]].all()


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_exclusive_scan_matches_jax(dtype):
    x = np.random.default_rng(3).integers(0, 5, (4, 300)).astype(dtype)
    want = np.asarray(JC.exclusive_scan(jnp.asarray(x)))
    got = PC.exclusive_scan(_t(x))
    assert got.dtype == _t(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_apply_permutation_matches_jax():
    """A hit record (NamedTuple with nested V3s and a None tangent) and a
    plain tuple of state planes, gathered leaf by leaf."""
    rng = np.random.default_rng(4)
    planes = [rng.random(N).astype(np.float32) for _ in range(11)]
    perm = rng.permutation(N).astype(np.int32)
    hit = wf.HitP(t=_t(planes[0]), normal=V3(*map(_t, planes[1:4])),
                  mat_id=_t(np.arange(N)), point=V3(*map(_t, planes[4:7])),
                  surf=V3(*map(_t, planes[7:10])), u=_t(planes[10]),
                  v=_t(planes[10]), outside=_t(planes[0] > 0.5))
    got = PC.apply_permutation(hit, _t(perm).long())
    jtree = tuple(jnp.asarray(p) for p in planes)
    want = JC.apply_permutation(jtree, jnp.asarray(perm))
    assert got.tan is None and isinstance(got.normal, V3)
    flat = [got.t, *got.normal, *got.point, *got.surf, got.u]
    for g, w in zip(flat, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got.mat_id.numpy(), perm)
    state = PC.apply_permutation((V3(*map(_t, planes[:3])), _t(perm)),
                                 _t(perm).long())
    assert isinstance(state, tuple) and isinstance(state[0], V3)
    np.testing.assert_array_equal(state[1].numpy(), perm[perm])
