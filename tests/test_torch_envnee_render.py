"""Mixed-mode NEE (area lights and the env map) of the torch port against
the JAX package: whole stratified iterations, plain one-sample and RIS.

The scene is scenes/textured_env.txt with one emissive sphere added
(tests/test_torch_envnee.py, `mixed_scene_path`); 32x32, depth 4; the lane
contract of tests/test_torch_megakernel.py (lanes to 1e-4, at most 1%
diverge, means within 0.05). JAX draws RIS candidates from jax.random even
when stratified (key fold_in(fold_in(keys[depth], 11), 13), as in
tests/test_torch_ris.py), so the test injects that block into the port's
trace through `ris_u`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.render import integrator as JI
from project3_cuda_path_tracer_tpu_torch import load_scene
from project3_cuda_path_tracer_tpu_torch.ops import texfetch
from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
from test_torch_envnee import DEPTH, M, RES, mixed_scene_path, sized, wired
from test_torch_megakernel import assert_lane_contract

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """(JAX scene, port scene) of textured_env with an emitter."""
    path = mixed_scene_path(tmp_path_factory.mktemp("mixed"))
    return jax_load_scene(path), load_scene(path)


def jax_candidates(key, n, rows):
    """The RIS candidate blocks the JAX trace draws with `key`, one a
    depth ([rows, N])."""
    _, k_bounce = jax.random.split(key)
    keys = jax.random.split(k_bounce, DEPTH)
    return [torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(keys[d], 11), 13), (rows, n),
        jnp.float32))) for d in range(DEPTH)]


@pytest.mark.parametrize("ris", [0, M])
def test_mixed_nee_iteration_matches_jax(ris, mixed):
    """One stratified mixed-mode NEE iteration at 32x32 depth 4 against the
    JAX trace: one light sample a bounce (8 lattice dims, salt 0x5B7E9D23:
    the selector, 3 area dims, 4 env dims), and RIS over M = 4 candidates
    (cdim 5) with JAX's candidate block injected. An area sample's shadow
    ray stops short of the light, an env sample's is unbounded; the torus
    answers both through its 8-wide BVH in the any-hit mode."""
    js, ps = (sized(s) for s in mixed)
    jcfg, pcfg = wired(js, ps)
    jcfg = dataclasses.replace(jcfg, nee_ris=ris)
    pcfg = dataclasses.replace(pcfg, nee_ris=ris)
    n = RES * RES
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    want = jax.jit(lambda k, it: JI.trace_wavefront(
        js.materials, js.camera.flat(), js.geoms, js.meshes, js.textures, k,
        jcfg, packed_meshes=js.packed_meshes, iteration=it))(key,
                                                             jnp.int32(0))
    ris_u = jax_candidates(key, n, 5 * M + 1) if ris else None
    got = PI.trace_wavefront(
        ps.materials, ps.camera.flat(), ps.geoms, texfetch.fuse(ps.textures),
        pcfg, iteration=0, packed_meshes=ps.packed_meshes, ris_u=ris_u)
    got = np.stack([c.numpy() for c in got])
    assert np.isfinite(got).all() and float(got.mean()) > 0
    assert_lane_contract(got, np.stack([np.asarray(c) for c in want]))
