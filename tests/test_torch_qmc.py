"""ops/qmc.py of the torch port (the Owen-scrambled Sobol sampler) against
the JAX package's, bit for bit.

The JAX functions compute in uint32; the port in int64 planes that hold the
same unsigned values. The inputs are seeded uint32 values over the whole
range, half of them at or above 2^31 (where a signed or truncated multiply
would go wrong), plus the edges 0, 2^31 - 1, 2^31 and 2^32 - 1. Every
function must return the same values exactly, and so must
`stratified_planes(impl="sobol")` and the Sobol camera rays.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.ops import qmc as JQ
from project3_cuda_path_tracer_tpu.ops import wavefront as JW
from project3_cuda_path_tracer_tpu_torch import load_scene
from project3_cuda_path_tracer_tpu_torch.ops import qmc as PQ
from project3_cuda_path_tracer_tpu_torch.ops import wavefront as PW

EDGES = [0, 1, 2**31 - 1, 2**31, 2**32 - 1]


def _u32(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    x[:len(EDGES)] = EDGES
    assert (x >= 2**31).mean() > 0.4
    return x


def _p(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _eq(got, want):
    got = got.numpy()
    want = np.asarray(want)
    if want.dtype == np.uint32:
        assert got.min() >= 0 and got.max() < 2**32
        np.testing.assert_array_equal(got.astype(np.uint32), want)
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("salt", [0, 0x2545F491, 0xFFFFFFFF])
def test_hash32_matches_jax(salt):
    x = _u32(seed=1)
    _eq(PQ.hash32(_p(x), salt), JQ.hash32(jnp.asarray(x), salt))


def test_reverse_bits_matches_jax():
    x = _u32(seed=2)
    _eq(PQ.reverse_bits32(_p(x)), JQ.reverse_bits32(jnp.asarray(x)))


def test_laine_karras_and_owen_scramble_match_jax():
    x, seed = _u32(seed=3), _u32(seed=4)
    _eq(PQ.laine_karras(_p(x), _p(seed)),
        JQ.laine_karras(jnp.asarray(x), jnp.asarray(seed)))
    _eq(PQ.owen_scramble(_p(x), _p(seed)),
        JQ.owen_scramble(jnp.asarray(x), jnp.asarray(seed)))


def test_mul32_is_the_low_word_of_the_product():
    x = _u32(seed=5)
    for c in (0x7FEB352D, 0x846CA68B, 0xFFFFFFFF, 1):
        want = (x.astype(object) * c) % 2**32
        np.testing.assert_array_equal(PQ._mul32(_p(x), c).numpy(),
                                      want.astype(np.int64))


def test_sobol2d_bits_match_jax():
    x = _u32(seed=6)
    gx, gy = PQ.sobol2d_bits(_p(x))
    wx, wy = JQ.sobol2d_bits(jnp.asarray(x))
    _eq(gx, wx)
    _eq(gy, wy)


def test_owen_sobol_pair_matches_jax():
    idx, s0, s1, s2 = (_u32(seed=k) for k in (7, 8, 9, 10))
    got = PQ.owen_sobol_pair(_p(idx), _p(s0), _p(s1), _p(s2))
    want = JQ.owen_sobol_pair(*(jnp.asarray(a) for a in (idx, s0, s1, s2)))
    for g, w in zip(got, want):
        _eq(g, w)
        assert float(g.min()) >= 0.0 and float(g.max()) <= 1.0


@pytest.mark.parametrize("num_dims", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("iteration,depth", [(0, 0), (7, 3),
                                             (2**31 + 5, 0x7FFFFFFF)])
def test_sample_planes_match_jax(num_dims, iteration, depth):
    pix = np.arange(0, 4096 * 997, 997, dtype=np.int64)
    salt = 0x2545F491
    want = JQ.sample_planes(jnp.uint32(iteration), depth,
                            jnp.asarray(pix.astype(np.int32)), num_dims,
                            salt)
    got = PQ.sample_planes(iteration, depth, torch.from_numpy(pix),
                           num_dims, salt)
    assert len(got) == len(want) == num_dims
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("impl", ["lattice", "sobol"])
def test_stratified_planes_impl_matches_jax(impl):
    pix = np.arange(3000, dtype=np.int64)
    for salt, dims in ((PW.SALT_BOUNCE, 4), (PW.SALT_RR, 1),
                       (PW.SALT_NEE_MIXED, 8)):
        want = JW.stratified_planes(5, 2, jnp.asarray(pix.astype(np.int32)),
                                    dims, salt, impl=impl)
        got = PW.stratified_planes(5, 2, torch.from_numpy(pix), dims, salt,
                                   impl=impl)
        for g, w in zip(got, want):
            _eq(g, w)
    with pytest.raises(ValueError, match="sampler"):
        PW.stratified_planes(0, 0, torch.from_numpy(pix), 2, 0, impl="halton")


def test_sobol_camera_rays_match_jax():
    """generate_rays_planar with the Sobol sampler on cornell_dof (AA, the
    lens and, on a shutter, time draws), at iteration 3: the same draws,
    so the rays agree to float32 rounding of the lens and normalisation."""
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes", "cornell_dof.txt")
    js, ps = jax_load_scene(path), load_scene(path)
    for s in (js, ps):
        s.camera.resolution = (32, 32)
        s.camera.derive()
        s.camera.shutter = 0.5
    import jax
    jo, jd, jt, jp = JW.generate_rays_planar(
        js.camera.flat(), 32, 32, jax.random.PRNGKey(0), stratified=True,
        iteration=3, strat_impl="sobol")
    po, pd, pt, pp = PW.generate_rays_planar(
        ps.camera.flat(), 32, 32, stratified=True, iteration=3,
        strat_impl="sobol")
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    for g, w in zip((*po, *pd), (*jo, *jd)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6)
    lattice = PW.generate_rays_planar(ps.camera.flat(), 32, 32,
                                      stratified=True, iteration=3)
    assert not torch.equal(lattice[1].x, pd.x)
