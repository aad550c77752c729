"""The material gather's backward (ops/matgrad.py): the plain version of
kernel G1 against a float64 sum and against the kernel's order of
summation written out lane by lane, and `_mat_select`'s two ways (the
gather as it was where nothing takes a gradient; `matgrad.select`, whose
backward is `mat_grad`, where the table does). The kernel against the
plain version, bit for bit, is tests/test_torch_cuda.py's. The train
step's gradients through `select` are held against jax.grad by
tests/test_torch_inverse.py and tests/test_torch_train_graph.py."""
import os

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu_torch import load_scene
from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
from project3_cuda_path_tracer_tpu_torch.models import optim
from project3_cuda_path_tracer_tpu_torch.ops import matgrad as MG
from project3_cuda_path_tracer_tpu_torch.ops import wavefront as wf
from project3_cuda_path_tracer_tpu_torch.ops.vec import V3
from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
from project3_cuda_path_tracer_tpu_torch.utils import cuda_build, launches

from torch_matgrad_cases import CASES, IDS, make

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_build(monkeypatch):
    """Fails the test if anything builds or loads a kernel library."""
    def refuse(name):
        raise AssertionError(f"cuda_build.load({name!r}) was called")
    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "build", refuse)


def _float64_sums(ids, planes, m):
    """[m, C] sums in float64 by index_add_, and the sums of |g|."""
    sums = torch.zeros((m, len(planes)), dtype=torch.float64)
    mags = torch.zeros_like(sums)
    for c, g in enumerate(planes):
        if g is not None:
            sums[:, c].index_add_(0, ids, g.double())
            mags[:, c].index_add_(0, ids, g.double().abs())
    return sums, mags


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_float64_sum(case, no_build):
    """Every (material, plane) within the float32 rounding of the order's
    longest chain of additions: 8 a thread, 5 + 8 a block, one a pass-2
    round, 5 + 8 again, each at most 2**-24 of the sum of |g|."""
    ids, planes, m = make(case)
    got = MG.mat_grad_plain(ids, planes, m)
    assert got.shape == (m, len(planes)) and got.dtype == torch.float32
    want, mags = _float64_sums(ids, planes, m)
    rounds = -(-len(ids) // (MG.BLOCK_LANES * MG.SUM_THREADS))
    err = (got.double() - want).abs()
    assert (err <= (34 + rounds) * 2.0 ** -24 * mags).all(), err.max()
    # a material no lane hits and a plane with no gradient read exactly 0
    assert (got.double()[mags == 0] == 0).all()
    assert not (torch.signbit(got) & (got == 0)).any()  # no -0.0


def _kernel_order_by_lanes(ids, planes, m):
    """csrc/mat_grad.cu's order written out with numpy float32, the block
    sums as the kernel's shuffles compute them (lane l adds lane l ^ off)."""
    n, c = len(ids), len(planes)
    blocks = -(-n // MG.BLOCK_LANES)
    pad = blocks * MG.BLOCK_LANES - n
    ids = np.concatenate([ids, np.full(pad, -1)])
    g = np.stack([np.zeros(n, np.float32) if p is None else p
                  for p in planes], -1)
    g = np.concatenate([g, np.zeros((pad, c), np.float32)])

    def block(x):  # [..., THREADS, m, c] -> [..., m, c]
        lanes = np.arange(32)
        x = x.reshape(x.shape[:-3] + (-1, 32) + x.shape[-2:])
        for off in (16, 8, 4, 2, 1):
            x = (x + x[..., lanes ^ off, :, :]).astype(np.float32)
        x = x[..., 0, :, :]
        s = x[..., 0, :, :]
        for w in range(1, x.shape[-3]):
            s = (s + x[..., w, :, :]).astype(np.float32)
        return s

    acc = np.zeros((blocks, MG.THREADS, m, c), np.float32)
    for k in range(MG.LANES_PER_THREAD):
        lane = (np.arange(blocks)[:, None] * MG.BLOCK_LANES
                + k * MG.THREADS + np.arange(MG.THREADS))
        hit = ids[lane][..., None] == np.arange(m)
        acc = (acc + np.where(hit[..., None], g[lane][:, :, None, :],
                              np.float32(0))).astype(np.float32)
    part = block(acc)
    tot = np.zeros((MG.SUM_THREADS, m, c), np.float32)
    for b in range(blocks):
        tot[b % MG.SUM_THREADS] = tot[b % MG.SUM_THREADS] + part[b]
    return block(tot)


@pytest.mark.parametrize("n", [2 * 2048 + 300, 257 * 2048 + 5])
def test_plain_repeats_the_kernels_order(n):
    """`mat_grad_plain` (halving trees, padded blocks) gives the bits of
    the kernel's order written out lane by lane, over one pass-2 round and
    over two."""
    ids, planes, m = make((3, 3, n, "random"), seed=1)
    want = _kernel_order_by_lanes(ids.numpy(), [p.numpy() for p in planes],
                                  m)
    got = MG.mat_grad_plain(ids, planes, m).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_plain_is_deterministic_and_dtype_follows_grads():
    ids, planes, m = make((5, 3, 10_000, "random"), seed=2)
    a = MG.mat_grad_plain(ids, planes, m)
    b = MG.mat_grad_plain(ids, planes, m)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    d = MG.mat_grad_plain(ids, [p.double() for p in planes], m)
    assert d.dtype == torch.float64
    assert torch.allclose(d, a.double(), rtol=1e-5, atol=1e-4)
    none = MG.mat_grad_plain(ids, [None, None, None], m)
    assert none.dtype == torch.float32 and not none.any()


@pytest.mark.parametrize("width", [1, 3])
@pytest.mark.parametrize("grad_mode", ["no_grad", "leaf_without_grad"])
def test_mat_select_without_grad_is_the_gather(width, grad_mode, no_build,
                                               monkeypatch):
    """Where nothing takes a gradient `_mat_select` is `table[mat_id]`,
    as before: the same values, no Function, nothing built."""
    def refuse(*a):
        raise AssertionError("the Function was used")
    monkeypatch.setattr(MG.MatSelect, "apply", refuse)
    rng = np.random.default_rng(3)
    shape = (5,) if width == 1 else (5, 3)
    table = torch.from_numpy(rng.random(shape, np.float32))
    ids = torch.from_numpy(rng.integers(0, 5, 1000))
    if grad_mode == "no_grad":
        table.requires_grad_(True)
        with torch.no_grad():
            got = wf._mat_select(table, ids)
    else:
        got = wf._mat_select(table, ids)
    want = table.detach()[ids]
    if width == 1:
        assert isinstance(got, torch.Tensor) and torch.equal(got, want)
    else:
        assert isinstance(got, V3)
        for c in range(3):
            assert torch.equal(got[c], want[:, c])


@pytest.mark.parametrize("width", [1, 3])
def test_mat_select_with_grad_on_cpu(width, no_build):
    """A table that takes a gradient goes through `matgrad.select`: the
    gather's values bit for bit, and a backward that is `mat_grad_plain`
    of the planes' gradients (None where a plane is unused), close to
    index_put_'s, with nothing built and no launch counted."""
    rng = np.random.default_rng(4)
    shape = (6,) if width == 1 else (6, 3)
    base = torch.from_numpy(rng.random(shape, np.float32))
    ids = torch.from_numpy(rng.integers(0, 6, 5000))
    w = torch.from_numpy(rng.standard_normal((3, 5000), np.float32))
    before = launches.launch_counts()
    table = base.clone().requires_grad_(True)
    got = wf._mat_select(table, ids)
    old = base.clone().requires_grad_(True)
    rows = old[ids]
    if width == 1:
        assert torch.equal(got.detach(), rows.detach())
        (got * w[0]).sum().backward()
        (rows * w[0]).sum().backward()
        want = MG.mat_grad_plain(ids, [w[0]], 6).view(6)
    else:
        assert isinstance(got, V3)
        for c in range(3):
            assert torch.equal(got[c].detach(), rows[:, c].detach())
        # plane y unused: its gradient arrives as None
        (got.x * w[0] + got.z * w[2]).sum().backward()
        (rows[:, 0] * w[0] + rows[:, 2] * w[2]).sum().backward()
        want = MG.mat_grad_plain(ids, [w[0], None, w[2]], 6)
        assert not table.grad[:, 1].any()
    assert torch.equal(table.grad, want)
    assert torch.allclose(table.grad, old.grad, rtol=1e-5, atol=1e-4)
    assert launches.launch_counts() == before


def test_select_takes_m_and_m3_tables_alone():
    ids = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        MG.select(torch.zeros((3, 2), requires_grad=True), ids)
    with pytest.raises(ValueError):
        MG.select(torch.zeros((3, 3, 1), requires_grad=True), ids)


def test_kernel_wrapper_checks_before_it_builds(no_build):
    ids = torch.zeros(8, dtype=torch.int64)
    g = torch.zeros(8)
    with pytest.raises(ValueError):
        MG._mat_grad_kernel(ids, [g, g], 2)
    with pytest.raises(ValueError):
        MG._mat_grad_kernel(ids, [g.double()], 2)
    with pytest.raises(ValueError):
        MG._mat_grad_kernel(ids, [g[:4]], 2)
    with pytest.raises(ValueError):
        MG._mat_grad_kernel(ids, [g], 0)
    with pytest.raises(ValueError):
        MG.mat_grad(ids.to("meta"), [g.to("meta")], 2)


def test_launch_counts_carry_mat_grad():
    assert "mat_grad" in launches.TALLY_SLOTS
    for _ in range(5):
        launches.count("mat_grad")
    assert launches.launch_counts()["mat_grad"] == 5
    launches.zero_launch_counts()
    assert not any(launches.launch_counts().values())


def test_cornell_train_step_reads_fields_through_select(no_build,
                                                        monkeypatch):
    """One cornell history step at depth 8 (the train cell's form) on the
    CPU: every material field read goes through the Function, 37 of its
    48 reads take a backward (`mat_grad_plain`, G1 on a card: 37 calls a
    step), and a render under no_grad takes none."""
    calls = {"select": 0, "backward": 0}
    plain, apply = MG.mat_grad_plain, MG.MatSelect.apply

    def counted_plain(*a):
        calls["backward"] += 1
        return plain(*a)

    def counted_apply(*a):
        calls["select"] += 1
        return apply(*a)
    monkeypatch.setattr(MG, "mat_grad_plain", counted_plain)
    monkeypatch.setattr(MG.MatSelect, "apply", counted_apply)
    scene = load_scene(os.path.join(REPO, "scenes", "cornell.txt"))
    scene.camera.resolution = (16, 16)
    scene.camera.derive()
    cfg = PInv.train_config(scene)
    assert cfg.trace_depth == 8
    dev = torch.device("cpu")
    tables = (PI.to_device(scene.geoms, dev), PI.to_device(scene.meshes, dev),
              PI.to_device(scene.textures, dev))
    params = PInv.params_from_scene(scene, dev)
    hist = PInv.make_seed_history(*tables, cfg)(
        params, PInv.step_generator(1, 0, dev))
    assert calls == {"select": 0, "backward": 0}
    step = PInv.make_train_step(*tables, cfg, history=True)
    *_, loss = step(params, optim.init(PInv.param_leaves(params)), hist,
                    PInv.step_generator(1, 1, dev), torch.zeros(16, 16, 3))
    assert torch.isfinite(loss)
    assert calls == {"select": 48, "backward": 37}
