"""RIS (--nee-ris M) and temporal ReSTIR (--restir M) of the torch port
against the JAX package, on scenes/manylights.txt (12 sphere lights over a
glossy floor) at 32x32 depth 4.

Every draw of a stratified iteration is a hash of (iteration, depth, pixel)
in both packages, except the RIS candidates: the JAX trace draws them from
jax.random even when stratified (integrator.py:561, key fold_in(fold_in(
keys[depth], 11), 13), where keys = split(split(key)[1], depth),
integrator.py:267, :314, :466). So the test draws the same blocks with
jax.random and injects them into the port's trace (`ris_u`), and the two
traces then hold the lane contract of tests/test_torch_megakernel.py
(lanes to 1e-4, at most 1% diverge, means within 0.05), images and
reservoir planes alike (W, which reaches tens, to a relative 1e-4).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.render import integrator as JI
from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
from test_torch_megakernel import assert_lane_contract
from test_torch_nee import NO_LIGHTS

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANYLIGHTS = os.path.join(REPO, "scenes", "manylights.txt")
RES, DEPTH, M, CAP = 32, 4, 4, 5.0


def _scenes(stratified=True):
    js, ps = jax_load_scene(MANYLIGHTS), load_scene(MANYLIGHTS)
    for s in (js, ps):
        s.camera.resolution = (RES, RES)
        s.camera.derive()
        s.settings.trace_depth = DEPTH
        s.settings.stratified = stratified
    return js, ps


def _cfgs(js, ps, restir):
    extra = dict(nee_ris=M, restir=restir, restir_cap=CAP)
    return (dataclasses.replace(
                JI._wire_nee(js, JI.build_trace_config(js, js.settings)),
                **extra),
            dataclasses.replace(PI._wire_nee(ps, PI.build_trace_config(ps)),
                                **extra))


def jax_candidates(key, n, restir):
    """The RIS candidate blocks the JAX trace draws with `key`, one a
    depth: [3M + 1, N], with one more row at depth 0 under ReSTIR."""
    _, k_bounce = jax.random.split(key)
    keys = jax.random.split(k_bounce, DEPTH)
    out = []
    for d in range(DEPTH):
        rows = 3 * M + (2 if restir and d == 0 else 1)
        k_l = jax.random.fold_in(keys[d], 11)
        out.append(torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(k_l, 13), (rows, n), jnp.float32))))
    return out


def _planes(v):
    return np.stack([np.asarray(c) for c in v])


def run_both(restir: bool, iterations: int):
    """Both traces over `iterations` stratified iterations (iteration i
    keyed fold_in(PRNGKey(0), i)), the reservoir carried under ReSTIR.
    Yields (port radiance, JAX radiance, port reservoir, JAX reservoir)."""
    js, ps = _scenes()
    jcfg, pcfg = _cfgs(js, ps, restir)
    assert jcfg.sphere_batch == pcfg.sphere_batch and len(pcfg.sphere_batch)
    n = RES * RES
    jtrace = jax.jit(lambda key, it, res: JI.trace_wavefront(
        js.materials, js.camera.flat(), js.geoms, js.meshes, js.textures,
        key, jcfg, iteration=it, reservoir=res))
    jres = JI.init_reservoir(n) if restir else None
    pres = PI.init_reservoir(n, "cpu") if restir else None
    for it in range(iterations):
        key = jax.random.fold_in(jax.random.PRNGKey(0), it)
        want = jtrace(key, jnp.int32(it), jres)
        got = PI.trace_wavefront(ps.materials, ps.camera.flat(), ps.geoms,
                                 ps.textures, pcfg, iteration=it,
                                 ris_u=jax_candidates(key, n, restir),
                                 reservoir=pres)
        if restir:
            (want, jres), (got, pres) = want, got
        yield _planes(got), _planes(want), pres, jres


def test_ris_matches_jax():
    """--nee-ris 4, two iterations, each under the lane contract."""
    for got, want, _, _ in run_both(restir=False, iterations=2):
        assert np.isfinite(got).all() and float(got.mean()) > 0
        assert_lane_contract(got, want)


def test_restir_matches_jax():
    """--restir 4, three iterations with the reservoir carried: each image
    and, after the third, every reservoir plane under the lane contract."""
    for got, want, pres, jres in run_both(restir=True, iterations=3):
        assert_lane_contract(got, want)
    assert set(pres) == set(PI.RESERVOIR_KEYS) == set(jres)
    for k in PI.RESERVOIR_KEYS:
        g, w = pres[k].numpy(), np.asarray(jres[k])
        scale = max(1.0, float(np.abs(w).max())) if k == "W" else 1.0
        assert_lane_contract(g[None] / scale, w[None] / scale)
    m = pres["M"].numpy()
    assert float(m.max()) == 3 * M
    np.testing.assert_array_equal(m % M, 0)


def _restir_renderer(**kw):
    _, ps = _scenes(stratified=False)
    ps.settings = dataclasses.replace(ps.settings, restir=M,
                                      restir_cap=CAP, seed=2, **kw)
    r = Renderer(ps, device="cpu")
    assert r.route == "wavefront" and r.cfg.restir and r.cfg.nee
    assert r.cfg.nee_ris == M and r.reservoir is not None
    return r


@pytest.mark.parametrize("antialias", [False, True])
def test_reservoir_m_growth_and_cap(antialias):
    """The Renderer carries the reservoir: M grows by M a step in multiples
    of M, some pixel keeps an unbroken run, the cap restir_cap * M holds,
    misses stay empty, and reset() empties it (the JAX
    test_reservoir_m_growth_and_cap and ..._under_aa)."""
    r = _restir_renderer(antialias=antialias)
    r.step_many(3)
    m = r.reservoir["M"].numpy()
    np.testing.assert_array_equal(m % M, 0)
    assert float(m.max()) == 3 * M
    if not antialias:
        r.step_many(3)   # 6 steps: 24 > the cap of 20
        m = r.reservoir["M"].numpy()
        assert float(m.max()) == CAP * M and float(m.min()) == 0.0
        np.testing.assert_array_equal(m % M, 0)
    r.reset()
    assert float(r.reservoir["M"].abs().max()) == 0.0
    assert r.iteration == 0


def test_ris_renderer_wiring():
    """nee_ris M >= 2 implies NEE and takes the wavefront route; ReSTIR
    raises nee_ris to M; both render finite, positive images."""
    _, ps = _scenes(stratified=False)
    ps.settings = dataclasses.replace(ps.settings, nee=True, nee_ris=8)
    r = Renderer(ps, device="cpu")
    assert r.cfg.nee and r.cfg.nee_ris == 8 and not r.cfg.restir
    assert r.reservoir is None
    img = r.render(2).numpy()
    assert np.isfinite(img).all() and img.mean() > 0


def test_restir_drops_without_lights(tmp_path, capsys):
    """A scene without area lights drops ReSTIR (and NEE) on one stderr
    line and renders plain (the JAX test_restir_requires_area_lights)."""
    path = tmp_path / "nolights.txt"
    path.write_text(NO_LIGHTS)
    scene = load_scene(str(path))
    scene.settings.restir = 2
    r = Renderer(scene, device="cpu")
    assert not r.cfg.restir and r.reservoir is None
    assert "restir" in capsys.readouterr().err
    r.render(2)
    assert np.isfinite(r.image()).all()
