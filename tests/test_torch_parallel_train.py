"""The port's sharded train step (zerovox_tpu_torch.training.make_sharded_train_step)
on the CPU, at TINY: against the JAX package's make_sharded_train_step on a
mesh of the same shape, and against the port's own one-device step on the
same global batch, on meshes of torch.device("cpu") repeated (the JAX side:
jax.devices()[:n] of the 8 virtual CPU devices, tests/conftest.py).

Tolerances are tests/test_torch_training.py's: losses rtol 1e-5; the SGD
step (p - p') / lr per leaf within 1e-3 * max|g_leaf| + 1e-6 * max|g|; two
AdamW steps within 2 * lr per step.  The TP reductions are held by float64
gradcheck.  Two JAX sharded steps are compiled in this file, one per JAX
test."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import zerovox_tpu.params as jparams
import zerovox_tpu.parallel as jpar
from zerovox_tpu.config import TINY_CONFIG as J_TINY
from zerovox_tpu.training import train as jtrain

import zerovox_tpu_torch.params as tparams
from zerovox_tpu_torch import parallel as tpar
from zerovox_tpu_torch.config import TINY_CONFIG as CFG
from zerovox_tpu_torch.parallel import tp
from zerovox_tpu_torch.training import fit, make_eval_fn, train as ttrain
from zerovox_tpu_torch.training.checkpoint import CheckpointManager
from zerovox_tpu_torch.training.cli import synthetic_dataset

RES = ((256, 30, 120), (128, 15, 60))
CPU = torch.device("cpu")
LR = 1.0       # the SGD steps: (p - p') / lr is then exact to the params' float32 ulps
#              (at lr 1e-2 a one-ulp move of p' is 1.5e-6 of step, beyond a small leaf's gate)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    pj = jparams.init_params(J_TINY, seed=0)
    pt = tparams.params_from_arrays(jparams.params_to_arrays(pj, J_TINY), CFG, device="cpu")
    return pj, pt


def _dataset(n, seed):
    """synthetic_dataset with row lengths that vary (the masks then matter)."""
    data = synthetic_dataset(CFG, n, seed=seed)
    lens = np.linspace(CFG.max_n_phonemes, CFG.max_n_phonemes // 2, n).astype(np.int32)
    return data._replace(num_phonemes=lens)


def cpu_mesh(data, model):
    return tpar.make_mesh(data=data, model=model, devices=[CPU] * (data * model))


def _sgd(lr=LR):
    return ttrain.Optimizer(lambda p: {},
                            lambda g, s, p: (tparams.tree_map(lambda x: -lr * x, g), s))


def _whole(state):
    return state.params.layout.gather(state.params)


def _steps_of(start, after, lr=LR):
    """{GGUF name: (p - p') / lr} of two whole port trees."""
    a, b = tparams.params_to_arrays(start, CFG), tparams.params_to_arrays(after, CFG)
    return {k: (a[k] - b[k]) / lr for k in a}


def _assert_arrays_close(want, got):
    """Per leaf max|d| <= 1e-3 * max|want_leaf| + 1e-6 * max|want|."""
    assert want.keys() == got.keys()
    gmax = max(np.abs(a).max() for a in want.values())
    assert gmax > 0
    for name, a in want.items():
        d = np.abs(a - got[name]).max()
        tol = 1e-3 * np.abs(a).max() + 1e-6 * gmax
        assert d <= tol, f"{name}: max|d| {d:.3e} > {tol:.3e}"


def _one_device(pt, data, optimizer=None, steps=1, **kw):
    state, step = ttrain.make_train_step(CFG, pt, optimizer=optimizer or _sgd(), device="cpu",
                                         **kw)
    out = []
    for _ in range(steps):
        state, losses = step(state, data)
        out.append({k: float(v) for k, v in losses.items()})
    return state, out


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("data,model,accum,use_stft", [(2, 2, 1, True), (2, 1, 2, False)])
def test_sharded_step_matches_jax(weights, data, model, accum, use_stft):
    """One SGD step of make_sharded_train_step against JAX's on a mesh of
    the same shape: the losses, and the step (p - p') / lr held as
    gradients are."""
    pj, pt = weights
    batch = _dataset(4, seed=11)
    jmesh = jpar.make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    jstate, jstep = jtrain.make_sharded_train_step(
        J_TINY, jmesh, pj, optimizer=optax.sgd(LR), use_stft=use_stft, stft_resolutions=RES,
        accum_steps=accum)
    jstate, lj = jstep(jstate, jpar.shard_batch(jtrain.TrainBatch(*map(jnp.asarray, batch)),
                                                jmesh))
    tstate, tstep = ttrain.make_sharded_train_step(
        CFG, cpu_mesh(data, model), pt, optimizer=_sgd(), use_stft=use_stft,
        stft_resolutions=RES, accum_steps=accum)
    tstate, lt = tstep(tstate, batch)
    assert sorted(lt) == sorted(lj)
    for k in lj:
        np.testing.assert_allclose(float(lt[k]), float(lj[k]), rtol=1e-5, err_msg=k)
    assert tstate.step == int(jstate.step) == 1
    jsteps = {k: (np.asarray(a) - np.asarray(b)) / LR for (k, a), (_, b) in zip(
        jparams.params_to_arrays(pj, J_TINY).items(),
        jparams.params_to_arrays(jstate.params, J_TINY).items())}
    _assert_arrays_close(jsteps, _steps_of(pt, _whole(tstate)))


# --------------------------------------------------------------------------
# against the port's one-device step
# --------------------------------------------------------------------------

MESHES = {
    "dp2": lambda: cpu_mesh(2, 1), "dp4": lambda: cpu_mesh(4, 1),
    "tp2": lambda: cpu_mesh(1, 2), "tp4": lambda: cpu_mesh(1, 4),
    "pod": lambda: tpar.make_pod_mesh(hosts=2, model=2, devices=[CPU] * 4),
}


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_step_matches_one_device(weights, name):
    """DP, TP and the pod layout against make_train_step on the same 4 rows,
    with the STFT loss: losses rtol 1e-5, the SGD step per leaf; the state
    lies as the mesh says (pieces on the master row, split leaves cut on
    the model axis)."""
    pt = weights[1]
    batch = _dataset(4, seed=5)
    one, l1 = _one_device(pt, batch, stft_resolutions=RES)
    mesh = MESHES[name]()
    state, step = ttrain.make_sharded_train_step(CFG, mesh, pt, optimizer=_sgd(),
                                                 stft_resolutions=RES)
    n_model = mesh.shape["model"]
    qkv = state.params["encoder"]["layers"][0]["attn"]["wq"]
    assert isinstance(qkv, list) if n_model > 1 else torch.is_tensor(qkv)
    state, lt = step(state, batch)
    for k in l1[0]:
        np.testing.assert_allclose(float(lt[k]), l1[0][k], rtol=1e-5, err_msg=k)
    _assert_arrays_close(_steps_of(pt, one.params), _steps_of(pt, _whole(state)))


def test_adamw_steps_match_one_device(weights):
    """Two AdamW steps (make_optimizer: the clip by global norm, replicated
    leaves counted once, split leaves as the sum of their pieces) on (2, 2)
    against one device: parameters within 2 * lr per step."""
    pt = weights[1]
    lr = 1e-3
    batch = _dataset(4, seed=6)
    one, l1 = _one_device(pt, batch, optimizer=ttrain.make_optimizer(lr), steps=2,
                          use_stft=False)
    state, step = ttrain.make_sharded_train_step(CFG, cpu_mesh(2, 2), pt,
                                                 optimizer=ttrain.make_optimizer(lr),
                                                 use_stft=False)
    for i in range(2):
        state, lt = step(state, batch)
        for k in lt:
            np.testing.assert_allclose(float(lt[k]), l1[i][k], rtol=1e-5 if i == 0 else 1e-3)
    assert state.opt_state["count"] == 2
    want, got = (tparams.params_to_arrays(t, CFG) for t in (one.params, _whole(state)))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2 * lr * 2, err_msg=k)


def test_dp_loss_is_the_global_batch_loss(weights):
    """The (2, 1) loss equals the one-device loss of the 4 rows at rtol 1e-5;
    the mean of the two rows' own losses does not, at that tolerance, in any
    term (the masked means divide by the whole batch's counts, the spectral
    convergence is a norm over the batch: 5.5e-5 apart here)."""
    pt = weights[1]
    batch = _dataset(4, seed=8)
    _, l1 = _one_device(pt, batch, stft_resolutions=RES)
    state, step = ttrain.make_sharded_train_step(CFG, cpu_mesh(2, 1), pt, optimizer=_sgd(),
                                                 stft_resolutions=RES)
    _, lt = step(state, batch)
    halves = [ttrain.loss_fn(pt, CFG, ttrain.batch_to(ttrain.TrainBatch(
        *(x[i:i + 2] for x in batch)), CPU), stft_resolutions=RES)[1] for i in (0, 2)]
    for k in ("mel_l1", "duration_mse", "stft", "total"):
        np.testing.assert_allclose(float(lt[k]), l1[0][k], rtol=1e-5)
        mean = (float(halves[0][k]) + float(halves[1][k])) / 2
        assert abs(mean - l1[0][k]) > 1e-5 * abs(l1[0][k]), (k, mean, l1[0][k])


def test_batches_that_do_not_split_over_the_data_axis(weights):
    state, step = ttrain.make_sharded_train_step(CFG, cpu_mesh(2, 1), weights[1],
                                                 use_stft=False, accum_steps=4)
    with pytest.raises(ValueError, match="a batch of 1 rows does not split over data=2"):
        step(state, _dataset(4, seed=1))
    state, step = ttrain.make_sharded_train_step(CFG, cpu_mesh(2, 1), weights[1],
                                                 use_stft=False)
    with pytest.raises(ValueError, match="a batch of 3 rows does not split over data=2"):
        step(state, _dataset(3, seed=1))


# --------------------------------------------------------------------------
# the TP reductions under autograd
# --------------------------------------------------------------------------

def _gradcheck(fn, *inputs):
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-7, rtol=1e-5)


def test_tp_reductions_gradcheck():
    """float64 gradcheck of the row-parallel sum, the gather, the per-channel
    cut, the column- and row-parallel products and a split-head attention:
    autograd follows the device copies and adds of parallel/tp.py."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64, requires_grad=True)

    a, b, c = r(2, 3, 4), r(2, 3, 4), r(2, 3, 2)
    _gradcheck(lambda a, b: tp._reduce([a, b], CPU), a, b)
    _gradcheck(lambda a, c: tp._gather([a, c], CPU), a, c)
    w0, w1, v = r(4, 5), r(2, 5), r(2, 6)
    _gradcheck(lambda v, w0, w1: tuple(tp._split_like(v, tp.Shards((w0, w1), 0))), v, w0, w1)
    x, b0, b1 = r(2, 3, 5), r(4), r(2)
    _gradcheck(lambda x, w0, w1, b0, b1: tuple(tp._col(
        tp.linear, x, tp.Shards((w0, w1), 0), tp.Shards((b0, b1), 0))), x, w0, w1, b0, b1)
    x0, x1, u0, u1, bias = r(2, 3, 4), r(2, 3, 2), r(5, 4), r(5, 2), r(5)
    _gradcheck(lambda x0, x1, u0, u1, bias: tp._row(
        tp.linear, [x0, x1], tp.Shards((u0, u1), 1), bias, CPU), x0, x1, u0, u1, bias)

    C, heads, n_dev = 8, 2, 4                  # half a head per device
    xa = r(1, 3, C)
    ws = {k: [r(C // n_dev, C) for _ in range(n_dev)] for k in ("wq", "wk", "wv")}
    bs = {k: [r(C // n_dev) for _ in range(n_dev)] for k in ("bq", "bk", "bv")}
    wo = [r(C, C // n_dev) for _ in range(n_dev)]
    rest = [r(C), r(C), r(C)]

    def attention(xa, *flat):
        it = iter(flat)
        p = {k: tp.Shards(tuple(next(it) for _ in range(n_dev)), 0)
             for k in ("wq", "wk", "wv", "bq", "bk", "bv")}
        p["wo"] = tp.Shards(tuple(next(it) for _ in range(n_dev)), 1)
        p["bo"], p["ln_g"], p["ln_b"] = next(it), next(it), next(it)
        return tp.attention_tp(xa, p, heads)
    flat = [t for k in ("wq", "wk", "wv") for t in ws[k]] + \
        [t for k in ("bq", "bk", "bv") for t in bs[k]] + wo + rest
    _gradcheck(attention, xa, *flat)


# --------------------------------------------------------------------------
# checkpoints, fit and the dry run on a mesh
# --------------------------------------------------------------------------

def test_checkpoint_from_a_mesh_resumes_on_others(weights, tmp_path):
    """A state saved on (2, 2) after an AdamW step is the whole tree and the
    whole moments; restored on (1, 1) and on (1, 2) it is the same bits, and
    the (1, 2) state cut into pieces again is the (2, 2) state's pieces."""
    pt = weights[1]
    batch = _dataset(4, seed=2)
    opt = ttrain.make_optimizer(1e-3)
    state, step = ttrain.make_sharded_train_step(CFG, cpu_mesh(2, 2), pt, optimizer=opt,
                                                 use_stft=False)
    state, _ = step(state, batch)
    layout = state.params.layout
    with CheckpointManager(str(tmp_path / "ck")) as mgr:
        mgr.save(state, wait=True)
        saved = torch.load(mgr.path(1), weights_only=True)
        for key in ("mu", "nu"):
            for x, y in zip(tparams.tree_leaves(saved["opt_state"][key]),
                            tparams.tree_leaves(layout.gather(state.opt_state[key]))):
                assert torch.equal(x, y)
        for target in (ttrain.make_train_step(CFG, pt, optimizer=opt, device="cpu")[0],
                       ttrain.make_sharded_train_step(CFG, cpu_mesh(1, 2), pt,
                                                      optimizer=opt)[0]):
            restored = mgr.restore(target)
            assert restored.step == 1 and restored.opt_state["count"] == 1
            lay = restored.params.layout
            for x, y in zip(tparams.tree_leaves(lay.gather(restored.params)),
                            tparams.tree_leaves(saved["params"])):
                assert torch.equal(x, y)
            for x, y in zip(tparams.tree_leaves(lay.gather(restored.opt_state["nu"])),
                            tparams.tree_leaves(saved["opt_state"]["nu"])):
                assert torch.equal(x, y)
        wq = restored.params["encoder"]["layers"][0]["attn"]["wq"]
        for x, y in zip(wq, state.params["encoder"]["layers"][0]["attn"]["wq"]):
            assert torch.equal(x, y)


def test_fit_on_a_mesh(weights):
    """fit with the (2, 1) step and make_eval_fn(cfg, mesh): the history of
    the one-device run (SGD: the steps differ only by float order)."""
    pt = weights[1]
    data = _dataset(12, seed=4)
    kw = dict(batch_size=4, epochs=2, val_split=0.34, seed=1)
    runs = []
    for mesh in (None, cpu_mesh(2, 1)):
        if mesh is None:
            state, step = ttrain.make_train_step(CFG, pt, optimizer=_sgd(1e-2), device="cpu",
                                                 use_stft=False)
        else:
            state, step = ttrain.make_sharded_train_step(CFG, mesh, pt, optimizer=_sgd(1e-2),
                                                         use_stft=False)
        state, hist = fit(state, step, data, eval_fn=make_eval_fn(CFG, mesh, use_stft=False),
                          **kw)
        assert state.step == 2 and len(hist) == 2
        runs.append(hist)
    for h1, hm in zip(*runs):
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(hm[k], h1[k], rtol=1e-5, err_msg=k)


def test_dryrun_train_step_and_hosts(capsys):
    """The dry run's sharded train step, on the pod layout of 2 hosts in one
    process, held against one device; every other regime's line too."""
    from zerovox_tpu_torch.tools.dryrun_multichip import main
    assert main(["4", "--device", "cpu", "--hosts", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    line = next(ln for ln in out if ln.startswith("dryrun_multichip train step OK"))
    assert "mesh={'data': 2, 'model': 2} hosts=2" in line
    assert out[-1].startswith("dryrun_multichip OK: 4 devices (1 distinct: cpu), hosts=2")
    assert "sharded train step" in out[-1]
