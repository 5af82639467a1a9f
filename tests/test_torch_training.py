"""The port's training (zerovox_tpu_torch.training) against the JAX package's
on the CPU, at TINY, on the same numpy-seeded inputs and weights.

Tolerances:
  * loss values: rtol 1e-5;
  * gradients, per leaf: max|d| <= 1e-3 * max|g_leaf| + 1e-6 * max|g| (max
    over every leaf).  Both packages are float32; against the port's loss
    computed in float64, the JAX gradients with the STFT loss are off by up
    to 7.8e-4 of a leaf's max|g| at this size (decoder norms, embeddings)
    and the port's by up to 1.4e-4, so 1e-4 would not hold the JAX package
    to the exact value.  The floor is for leaves whose exact gradient is 0
    (attention key biases, conv biases in front of an instance norm): both
    packages give float noise there;
  * schedules: 1e-7 at every step; the optimizer fed the same gradients
    for 5 steps: 1e-6;
  * a whole train_step under SGD: the step it takes, (p - p') / lr, is held
    as the gradients are; under AdamW only 2 * lr per step on the params,
    since Adam turns float noise in near-zero gradients into lr-sized steps
    (tests/test_parallel.py:123-128).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import numpy as np
import optax
import pytest
import torch

import zerovox_tpu.params as jparams
from zerovox_tpu.config import TINY_CONFIG as J_TINY
from zerovox_tpu.models import hifigan as jhifigan
from zerovox_tpu.training import losses as jlosses
from zerovox_tpu.training import train as jtrain
from zerovox_tpu.training.checkpoint import export_weights_gguf as j_export

import zerovox_tpu_torch.params as tparams
from zerovox_tpu_torch.config import TINY_CONFIG as CFG
from zerovox_tpu_torch.models import hifigan
from zerovox_tpu_torch.ops.cuda import mrf_stage as ms
from zerovox_tpu_torch.training import losses as tlosses
from zerovox_tpu_torch.training import train as ttrain
from zerovox_tpu_torch.training.checkpoint import CheckpointManager, export_weights_gguf
from zerovox_tpu_torch.training.cli import synthetic_dataset

# the modules (the packages export their function `fit` under the same name)
jfit = importlib.import_module("zerovox_tpu.training.fit")
tfit = importlib.import_module("zerovox_tpu_torch.training.fit")

RES = ((256, 30, 120), (128, 15, 60))       # the CLI's STFT resolutions at TINY
CPU = torch.device("cpu")


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


def _jbatch(data):
    return jtrain.TrainBatch(*(jnp.asarray(x) for x in data))


def _arrays_j(tree):
    return {k: np.asarray(v) for k, v in jparams.params_to_arrays(tree, J_TINY).items()}


def _arrays_t(tree):
    return tparams.params_to_arrays(tree, CFG)


def _assert_arrays_close(want, got):
    """Gradients by GGUF name: per leaf max|d| <= 1e-3 * max|want_leaf| +
    1e-6 * max|want| (module docstring)."""
    assert want.keys() == got.keys()
    gmax = max(np.abs(a).max() for a in want.values())
    assert gmax > 0
    for name, a in want.items():
        d = np.abs(a - got[name]).max()
        tol = 1e-3 * np.abs(a).max() + 1e-6 * gmax
        assert d <= tol, f"{name}: max|d| {d:.3e} > {tol:.3e}"


def _assert_grads_close(gj, gt):
    _assert_arrays_close(_arrays_j(gj), _arrays_t(gt))


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _loss_case(name, rng):
    B, T, M, L = 2, 24, 5, 6000
    pred = rng.normal(size=(B, T, M)).astype(np.float32)
    target = rng.normal(size=(B, T, M)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([[T], [T - 7]])
    wav_p = rng.normal(scale=0.1, size=(B, L)).astype(np.float32)
    wav_t = rng.normal(scale=0.1, size=(B, L)).astype(np.float32)
    wav_t[1, :500] = 0.0                     # frames below the magnitude's clip
    log_d = rng.normal(size=(B, 11)).astype(np.float32)
    dur = rng.integers(0, 5, size=(B, 11)).astype(np.int32)
    pmask = np.arange(11)[None, :] < np.array([[11], [6]])
    return {
        "masked_mse": ("masked_mse", (pred[..., 0], target[..., 0], mask)),
        "masked_l1_bt_mask": ("masked_l1", (pred, target, mask)),
        "masked_l1_full_mask": ("masked_l1", (pred, target, np.broadcast_to(mask[..., None], pred.shape))),
        "masked_l1_empty_mask": ("masked_l1", (pred, target, np.zeros_like(mask))),
        "stft_magnitude": ("stft_magnitude", (wav_t, 1024, 120, 600)),
        "stft_loss_default": ("stft_loss", (wav_p, wav_t)),
        "stft_loss_tiny": ("stft_loss", (wav_p, wav_t, RES)),
        "tts_losses": ("tts_losses", (pred, target, mask, log_d, dur, pmask, wav_p, wav_t, RES)),
        "tts_losses_no_wav": ("tts_losses", (pred, target, mask, log_d, dur, pmask)),
    }[name]


@pytest.mark.parametrize("case", ["masked_mse", "masked_l1_bt_mask", "masked_l1_full_mask",
                                  "masked_l1_empty_mask", "stft_magnitude", "stft_loss_default",
                                  "stft_loss_tiny", "tts_losses", "tts_losses_no_wav"])
def test_losses_match_jax(rng, case):
    fn, args = _loss_case(case, rng)
    arrays = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]

    def jfn(*xs):                        # jitted: eager JAX runs the STFT op by op
        full = list(args)
        for i, x in zip(arrays, xs):
            full[i] = x
        return getattr(jlosses, fn)(*full)
    want = jax.jit(jfn)(*(jnp.asarray(args[i]) for i in arrays))
    got = getattr(tlosses, fn)(*(torch.as_tensor(np.ascontiguousarray(a))
                                 if isinstance(a, np.ndarray) else a for a in args))
    if isinstance(want, dict):
        assert list(got)[-1] == "total" and sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5)
    else:
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_stft_window_is_symmetric_hann():
    """The port's window is jnp.hanning's (symmetric); jnp.hanning computes
    its cosines in float32, so the two agree to a few float32 ulps of 1."""
    np.testing.assert_allclose(
        torch.hann_window(600, periodic=False, dtype=torch.float64).numpy(),
        np.asarray(jnp.hanning(600)), rtol=0, atol=5e-7)
    assert not np.allclose(torch.hann_window(600, dtype=torch.float64).numpy(),
                           np.asarray(jnp.hanning(600)), atol=1e-5)


# --------------------------------------------------------------------------
# the repair: the kernel refuses autograd; the vocoder's differentiable route
# --------------------------------------------------------------------------

def _stage_args(device, grad_on=None):
    """A stage's arguments with every tensor on `device` (meta: a tensor that
    is not on the CPU, without a card); grad_on names the one that requires
    a gradient."""
    C, Cin = 8, 16

    def t(*shape, name):
        return torch.zeros(*shape, device=device).requires_grad_(grad_on == name)
    blocks = [{"convs1": [{"w": t(C, C, 3, name="w"), "b": t(C, name="b")}],
               "convs2": [{"w": t(C, C, 3, name="w2"), "b": t(C, name="b2")}]}]
    up = dict(w=t(C, Cin, 4, name="up"), stride=2, padding=1, output_padding=0)
    return t(1, 5, Cin, name="x"), blocks, up, t(C, name="in_bias")


@pytest.mark.parametrize("grad_on", ["x", "w", "b", "w2", "b2", "up", "in_bias"])
def test_kernel_refuses_autograd(grad_on):
    x, blocks, up, in_bias = _stage_args("meta", grad_on)
    with pytest.raises(RuntimeError, match="differentiable=True"):
        ms.refuse_autograd(x, blocks, up, in_bias)
    # the wrapper reaches the check on a tensor that is not on the CPU,
    # before anything would be built or launched
    with pytest.raises(RuntimeError, match="no backward"):
        ms.mrf_stage(x, blocks, [(1,)], 3, upsample=up, in_bias=in_bias, in_leaky=0.1)
    if grad_on in ("x", "w", "b", "w2", "b2"):
        with pytest.raises(RuntimeError, match="no backward"):
            ms.mrf_stage_unfolded(torch.zeros(1, 5, 8, device="meta",
                                              requires_grad=grad_on == "x"), blocks, [(1,)], 3)
    with torch.no_grad():
        ms.refuse_autograd(x, blocks, up, in_bias)        # nothing to cut
    ms.refuse_autograd(*_stage_args("meta"))              # nothing requires a gradient


@pytest.mark.parametrize("op", ["layer_norm", "instance_norm", "conv1d", "linear",
                                "attention", "mrf_stage_ref"])
def test_float64_is_computed_in_float64(rng, op):
    """The plain path computes float64 tensors in float64 (the reference the
    gradient checks hold float32 against): a change of the input below
    float32's resolution moves the output.  The kernel refuses float64."""
    from zerovox_tpu_torch.ops import conv1d, instance_norm, layer_norm, linear
    from zerovox_tpu_torch.ops.attention import multi_head_attention
    x = torch.as_tensor(rng.normal(size=(2, 12, 8)))
    w = torch.as_tensor(rng.normal(size=(8, 8, 3)))
    attn = {k: torch.as_tensor(rng.normal(scale=0.3, size=(8, 8))) for k in ("wq", "wk", "wv", "wo")}
    attn.update({k: torch.zeros(8, dtype=torch.float64)
                 for k in ("bq", "bk", "bv", "bo", "ln_b")}, ln_g=torch.ones(8, dtype=torch.float64))
    blocks = [{"convs1": [{"w": w, "b": torch.zeros(8, dtype=torch.float64)}],
               "convs2": [{"w": w.flip(-1), "b": torch.zeros(8, dtype=torch.float64)}]}]
    fn = {"layer_norm": layer_norm, "instance_norm": instance_norm,
          "conv1d": lambda t: conv1d(t, w, padding=1),
          "linear": lambda t: linear(t, w[..., 0]),
          "attention": lambda t: multi_head_attention(t, attn, 2),
          "mrf_stage_ref": lambda t: ms.mrf_stage_ref(t, blocks, [(1,)], 3, out_leaky=0.1)}[op]
    y = fn(x)
    assert y.dtype == torch.float64
    assert (fn(x * (1 + 1e-11)) - y).abs().max() > 0
    if op == "mrf_stage_ref":
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            ms.mrf_stage(x.to("meta"), blocks, [(1,)], 3)


def test_cpu_stage_keeps_the_graph():
    x, blocks, up, in_bias = _stage_args(CPU, "w")
    y = ms.mrf_stage(x, blocks, [(1,)], 3, upsample=up, in_bias=in_bias, in_leaky=0.1)
    assert y.grad_fn is not None


def test_vocode_differentiable_matches_jax(weights, rng):
    """The gradient of a weighted sum of the waveform with respect to every
    vocoder weight: vocode(differentiable=True) against the JAX vocoder's
    route in loss_fn (vocoder_backend="folded", plain XLA convolutions)."""
    pj, pt = weights
    mel = rng.normal(size=(2, 40, CFG.num_mels)).astype(np.float32)
    w = rng.normal(size=(2, 40 * CFG.hop_size)).astype(np.float32)
    jcfg = J_TINY.replace(vocoder_backend="folded")
    gj = jax.jit(jax.grad(lambda p: jnp.sum(jhifigan.vocode(p, jcfg, jnp.asarray(mel)) * w)))(pj)
    live = tparams.tree_map(lambda t: t.detach().requires_grad_(), pt)
    out = torch.sum(hifigan.vocode(live, CFG, torch.as_tensor(mel), differentiable=True)
                    * torch.as_tensor(w))
    leaves = tparams.tree_leaves(live["vocoder"])
    grads = iter(torch.autograd.grad(out, leaves))
    gt_voc = tparams.tree_map(lambda _: next(grads), live["vocoder"])
    gt = tparams.tree_map(torch.zeros_like, pt)
    gt["vocoder"] = gt_voc
    _assert_grads_close(gj, gt)
    assert all(float(g.abs().max()) > 0 for g in tparams.tree_leaves(gt_voc))


# --------------------------------------------------------------------------
# loss_fn and its gradients
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loss_batch():
    return _dataset(2, seed=5)


@pytest.fixture(scope="module")
def jax_grad_fn():
    """use_stft -> JAX's jitted value_and_grad of loss_fn, compiled once per
    module (the loss tests and the AdamW step share it)."""
    fns = {}

    def get(use_stft):
        if use_stft not in fns:
            fns[use_stft] = jax.jit(jax.value_and_grad(
                lambda p, b: jtrain.loss_fn(p, J_TINY, b, use_stft=use_stft,
                                            stft_resolutions=RES), has_aux=True))
        return fns[use_stft]
    return get


@pytest.mark.parametrize("use_stft", [False, True])
def test_loss_fn_and_grads_match_jax(weights, loss_batch, jax_grad_fn, use_stft):
    pj, pt = weights
    (_, lj), gj = jax_grad_fn(use_stft)(pj, _jbatch(loss_batch))
    batch = ttrain.batch_to(loss_batch, CPU)
    lt, gt = ttrain.value_and_grad(pt, CFG, batch, use_stft, RES)
    assert sorted(lt) == sorted(lj)
    for k in lj:
        np.testing.assert_allclose(float(lt[k]), float(lj[k]), rtol=1e-5)
    _assert_grads_close(gj, gt)
    # both float32 gradients against the port's loss computed in float64
    wide = lambda t: t.double() if t.is_floating_point() else t     # noqa: E731
    l64, g64 = ttrain.value_and_grad(tparams.tree_map(wide, pt), CFG,
                                     ttrain.TrainBatch(*map(wide, batch)), use_stft, RES)
    assert tparams.tree_leaves(g64)[0].dtype == torch.float64
    np.testing.assert_allclose(float(lt["total"]), float(l64["total"]), rtol=1e-6)
    _assert_arrays_close(_arrays_t(g64), _arrays_j(gj))
    _assert_arrays_close(_arrays_t(g64), _arrays_t(gt))
    voc = tparams.tree_leaves(gt["vocoder"])
    assert all(float(g.abs().max()) > 0 for g in voc) == use_stft


# --------------------------------------------------------------------------
# schedules and the optimizer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("schedule,warmup,total", [
    ("constant", 0, 10), ("constant", 3, 10), ("cosine", 0, 10), ("cosine", 4, 12),
    ("cosine", 20, 6), ("constant", 9, 1)])
def test_lr_schedules_match_optax(schedule, warmup, total):
    js = jtrain.make_lr_schedule(1e-3, total, schedule=schedule, warmup_steps=warmup)
    ts = ttrain.make_lr_schedule(1e-3, total, schedule=schedule, warmup_steps=warmup)
    if not callable(js):
        assert ts == js
        return
    for count in range(total + 3):
        assert abs(ts(count) - float(js(count))) <= 1e-7, count
    if warmup and total > 1:
        assert ts(0) == 0.0


@pytest.mark.parametrize("kw", [dict(schedule="linear"), dict(warmup_steps=-1)])
def test_lr_schedule_errors_match(kw):
    with pytest.raises(ValueError) as je:
        jtrain.make_lr_schedule(1e-3, 10, **kw)
    with pytest.raises(ValueError) as te:
        ttrain.make_lr_schedule(1e-3, 10, **kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("clip_active", [False, True])
@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_optimizer_matches_optax(rng, clip_active, schedule):
    """5 steps fed the same gradients against optax.chain(clip_by_global_norm,
    adamw), with the clip active (global norm 10-30) or not (0.1-0.3)."""
    shapes = {"a": (3, 4), "b": [(5,), (2, 2, 3)], "c": (1,)}
    params = {"a": rng.normal(size=(3, 4)), "b": [rng.normal(size=(5,)), rng.normal(size=(2, 2, 3))],
              "c": rng.normal(size=(1,))}
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    scale = 10.0 if clip_active else 0.1
    grads = [jax.tree.map(lambda s: (scale * rng.normal(size=s)).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple))
             for _ in range(5)]
    lr_j = jtrain.make_lr_schedule(1e-2, 5, schedule=schedule, warmup_steps=2)
    lr_t = ttrain.make_lr_schedule(1e-2, 5, schedule=schedule, warmup_steps=2)
    jopt = optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(lr_j, b1=0.9, b2=0.98, eps=1e-8, eps_root=0.0,
                                   weight_decay=1e-2))
    topt = ttrain.make_optimizer(lr_t, weight_decay=1e-2, clip_norm=1.0)
    pj = jax.tree.map(jnp.asarray, params)
    pt = tparams.tree_map(torch.as_tensor, params)
    sj, st = jopt.init(pj), topt.init(pt)
    for g in grads:
        norm = np.sqrt(sum(np.sum(x.astype(np.float64) ** 2) for x in jax.tree.leaves(g)))
        assert (norm >= 1.0) == clip_active
        uj, sj = jopt.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = optax.apply_updates(pj, uj)
        ut, st = topt.update(tparams.tree_map(torch.as_tensor, g), st, pt)
        pt = ttrain.apply_updates(pt, ut)
        for a, b in zip(jax.tree.leaves(pj), tparams.tree_leaves(pt)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    assert st["count"] == 5
    moved = max(np.abs(np.asarray(a) - b).max()
                for a, b in zip(jax.tree.leaves(pj), jax.tree.leaves(params)))
    assert moved > 1e-3


# --------------------------------------------------------------------------
# the whole step
# --------------------------------------------------------------------------

def _port_sgd(lr):
    return ttrain.Optimizer(lambda p: {},
                            lambda g, s, p: (tparams.tree_map(lambda x: -lr * x, g), s))


@pytest.mark.parametrize("accum", [1, 4])
def test_train_step_sgd_matches_jax(weights, accum):
    """One SGD step against JAX's train_step: the step's (p - p') / lr is
    held as the gradients are.  The STFT route at accum 1 (and in loss_fn's
    test); accumulation without it, which halves its JAX compile."""
    pj, pt = weights
    data = _dataset(4, seed=7)
    lr = 1e-2
    stft = dict(use_stft=accum == 1, stft_resolutions=RES)
    jopt = optax.sgd(lr)
    jstep = jax.jit(functools.partial(jtrain.train_step, cfg=J_TINY, optimizer=jopt,
                                      accum_steps=accum, **stft))
    js, lj = jstep(jtrain.TrainState(pj, jopt.init(pj), jnp.zeros((), jnp.int32)),
                   _jbatch(data))
    ts, tstep = ttrain.make_train_step(CFG, pt, optimizer=_port_sgd(lr), device="cpu",
                                       accum_steps=accum, **stft)
    start = [t.clone() for t in tparams.tree_leaves(ts.params)]
    ts, lt = tstep(ts, data)
    for k in lj:
        np.testing.assert_allclose(float(lt[k]), float(lj[k]), rtol=1e-5)
    assert ts.step == int(js.step) == 1
    _assert_grads_close(jax.tree.map(lambda a, b: (a - b) / lr, pj, js.params),
                        tparams.tree_map(lambda a, b: (a - b) / lr, pt, ts.params))
    # the step is functional: the state it started from is unchanged
    for a, b in zip(start, tparams.tree_leaves(pt)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_step_adamw_matches_jax(weights, loss_batch, jax_grad_fn):
    """Two AdamW steps (make_optimizer, the CLI's) against JAX's step done
    in its parts: loss_fn's jitted gradient, then make_optimizer's optax
    update on the raveled tree (the clip's norm is global and AdamW acts
    element by element, so it is the same update; one leaf compiles in a
    fraction of the time of every leaf).  Within 2 * lr per step."""
    pj, pt = weights
    lr = 1e-3
    jopt = jtrain.make_optimizer(lr)
    flat, unravel = ravel_pytree(pj)
    update, jstate = jax.jit(jopt.update), jopt.init(flat)
    ts, tstep = ttrain.make_train_step(CFG, pt, optimizer=ttrain.make_optimizer(lr),
                                       device="cpu", use_stft=False)
    for i in range(2):
        (_, lj), gj = jax_grad_fn(False)(unravel(flat), _jbatch(loss_batch))
        updates, jstate = update(ravel_pytree(gj)[0], jstate, flat)
        flat = optax.apply_updates(flat, updates)
        ts, lt = tstep(ts, loss_batch)
        for k in lj:       # after the first step the params differ by up to 2 * lr
            np.testing.assert_allclose(float(lt[k]), float(lj[k]), rtol=1e-5 if i == 0 else 1e-3)
    assert ts.step == 2 and ts.opt_state["count"] == 2
    aj, at = _arrays_j(unravel(flat)), _arrays_t(ts.params)
    for name in aj:
        np.testing.assert_allclose(at[name], aj[name], rtol=0, atol=2 * lr * 2, err_msg=name)
    assert max(np.abs(at[n] - a).max() for n, a in _arrays_t(pt).items()) > lr


def test_train_step_rejects_indivisible_accum(weights):
    state, step = ttrain.make_train_step(CFG, weights[1], device="cpu", use_stft=False,
                                         accum_steps=4)
    with pytest.raises(ValueError, match="batch 6 not divisible by accum_steps=4"):
        step(state, _dataset(6, seed=1))


# --------------------------------------------------------------------------
# fit
# --------------------------------------------------------------------------

def test_fit_matches_jax(tmp_path):
    """The epoch loop alone, with a step and an eval whose loss is the sum
    of the batch's phoneme ids (exact in float32): the same batch order
    (whole-set shuffle, then the train region each epoch), callbacks and
    history, to the last bit, over 2 epochs of 4 train batches and 1
    validation batch with the trailing datum dropped; checkpoints on the
    step cadence.  fit driving the real step is the CLI test's."""
    data = _dataset(11, seed=9)
    kw = dict(batch_size=2, epochs=2, val_split=0.2, seed=3)
    runs = {}
    for pkg, fit, state, total in (
            ("jax", jfit.fit, jtrain.TrainState({"w": jnp.zeros(1)}, None, 0),
             lambda b: jnp.sum(b.src_seq).astype(jnp.float32)),
            ("port", tfit.fit, ttrain.TrainState({"w": torch.zeros(1)}, {}, 0),
             lambda b: b.src_seq.sum().float())):
        seen, calls = [], []

        def step(state, batch, seen=seen, total=total):
            seen.append(np.asarray(batch.src_seq).copy())
            return state._replace(step=state.step + 1), {"total": total(batch)}

        with CheckpointManager(str(tmp_path / "ck"), max_to_keep=2) as mgr:
            out, hist = fit(state, step,
                            jtrain.TrainBatch(*data) if pkg == "jax" else data,
                            eval_fn=lambda params, batch, total=total: {"total": total(batch)},
                            callback=lambda *a, calls=calls: calls.append(a[:4] + (float(a[4]),)),
                            checkpoint_manager=mgr if pkg == "port" else None,
                            checkpoint_every=3, **kw)
            if pkg == "port":
                mgr.wait_until_finished()
                assert mgr.steps() == [3, 6]
                assert out.step == 8
        runs[pkg] = (seen, calls, [{k: v for k, v in h.items() if k != "seconds"} for h in hist])
    (tseen, tcalls, thist), (jseen, jcalls, jhist) = runs["port"], runs["jax"]
    assert len(tseen) == len(jseen) == 8
    for a, b in zip(tseen, jseen):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(tseen[:4], tseen[4:]))   # reshuffled
    assert tcalls == jcalls and len(tcalls) == 10
    assert thist == jhist and thist[0]["train_loss_unc"] > 0 and "val_loss" in thist[1]


@pytest.mark.parametrize("kw", [
    dict(batch_size=2, val_split=1.0), dict(batch_size=2, val_split=-0.1),
    dict(batch_size=5), dict(batch_size=2, val_split=0.1),
    dict(batch_size=4, val_split=0.5)])
def test_fit_errors_match_jax(kw):
    data = _dataset(4, seed=0)
    noop = lambda s, b: (s, {"total": 0.0})          # noqa: E731
    with pytest.raises(ValueError) as je:
        jfit.fit(None, noop, jtrain.TrainBatch(*data), **kw)
    with pytest.raises(ValueError) as te:
        tfit.fit(ttrain.TrainState({"w": torch.zeros(1)}, {}, 0), noop, data, **kw)
    assert str(te.value) == str(je.value)


# --------------------------------------------------------------------------
# checkpoints and the export
# --------------------------------------------------------------------------

def test_checkpoint_save_restore_resume(weights, tmp_path):
    data = _dataset(2, seed=4)
    state, step = ttrain.make_train_step(CFG, weights[1], device="cpu", use_stft=False)
    fresh = state
    state1, _ = step(state, data)
    with CheckpointManager(str(tmp_path / "ck")) as mgr:
        assert mgr.latest_step() is None
        with pytest.raises(FileNotFoundError):
            mgr.restore(fresh)
        assert mgr.save(state1) == 1
        assert mgr.latest_step() == 1
    with CheckpointManager(str(tmp_path / "ck")) as mgr:   # a new process would do this
        restored = mgr.restore(fresh)
    assert restored.step == 1 and restored.opt_state["count"] == 1
    for a, b in zip(tparams.tree_leaves(restored), tparams.tree_leaves(state1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    cont, _ = step(restored, data)
    direct, _ = step(state1, data)
    for a, b in zip(tparams.tree_leaves(cont), tparams.tree_leaves(direct)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [n for n in (tmp_path / "ck").iterdir() if n.name.endswith(".tmp")] == []


def test_checkpoint_retention_deletes(weights, tmp_path):
    state, _ = ttrain.make_train_step(CFG, weights[1], device="cpu", use_stft=False)
    with CheckpointManager(str(tmp_path / "ck"), max_to_keep=2) as mgr:
        for s in (1, 2, 3, 4):
            mgr.save(state, step=s)
        mgr.wait_until_finished()
        assert mgr.latest_step() == 4
        assert mgr.steps() == [3, 4]
        assert mgr.restore(state, step=3).step == 0       # the state's own step
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_3.pt", "step_4.pt"]


def test_checkpoint_restore_rejects_another_geometry(weights, tmp_path):
    state, _ = ttrain.make_train_step(CFG, weights[1], device="cpu", use_stft=False)
    other = tparams.init_params(CFG.replace(hifigan_channels=64), seed=0, device="cpu")
    ostate, _ = ttrain.make_train_step(CFG, other, device="cpu", use_stft=False)
    with CheckpointManager(str(tmp_path / "ck")) as mgr:
        mgr.save(ostate, wait=True)
        with pytest.raises(ValueError, match="vocoder"):
            mgr.restore(state)


def test_export_equals_jax_export(weights, tmp_path):
    """The port's export of a training state is the JAX export of the same
    weights, byte for byte."""
    state, _ = ttrain.make_train_step(CFG, weights[1], device="cpu", use_stft=False)
    pj = jparams.params_from_arrays(_arrays_t(state.params), J_TINY)
    tpath, jpath = tmp_path / "t.gguf", tmp_path / "j.gguf"
    export_weights_gguf(str(tpath), state, CFG)
    j_export(str(jpath), jtrain.TrainState(pj, None, jnp.zeros((), jnp.int32)), J_TINY)
    assert tpath.read_bytes() == jpath.read_bytes()


# --------------------------------------------------------------------------
# serving never takes the differentiable route
# --------------------------------------------------------------------------

def test_serving_entries_never_take_the_differentiable_route(weights, monkeypatch, tmp_path):
    from zerovox_tpu_torch import cli
    from zerovox_tpu_torch.models.pipeline import synthesize
    from zerovox_tpu_torch.models.streaming import StreamingSynthesizer
    from zerovox_tpu_torch.runtime.client import TTSClient
    from zerovox_tpu_torch.runtime.engine import TTSEngine
    from zerovox_tpu_torch.runtime.longform import synthesize_long
    from zerovox_tpu_torch.runtime.server import TTSServer

    pt = weights[1]

    # every TINY stage takes the plain route on any device (the kernel does
    # not take its widths), so the refusal is of the differentiable flag itself
    vocode = hifigan.vocode

    def refuse(*a, differentiable=False, **kw):
        if differentiable:
            raise AssertionError("a serving path took vocode(differentiable=True)")
        return vocode(*a, **kw)
    monkeypatch.setattr(hifigan, "vocode", refuse)
    rng = np.random.default_rng(0)
    P = CFG.max_n_phonemes
    src = rng.integers(1, CFG.num_phonemes, size=(2, P))
    pun = rng.integers(0, CFG.num_puncts, size=(2, P))
    style = rng.normal(scale=0.1, size=(2, CFG.d_model)).astype(np.float32)
    assert synthesize(pt, CFG, src, pun, style, device="cpu").wav.shape[0] == 2
    for precision in ("float32", "bfloat16"):
        engine = TTSEngine(pt, CFG, mel_buckets=(16, 32), precision=precision, device="cpu")
        engine.synthesize(src[:1], pun[:1], style[:1])
        engine.synthesize_packed(src, pun, style, [P, P // 2])
        engine.synthesize_async(src, pun, style)()
        synthesize_long(engine, src[0].repeat(3), pun[0].repeat(3), style[:1])
        stream = StreamingSynthesizer(pt, CFG.replace(compute_dtype=precision),
                                      chunk_frames=16, overlap=4, device="cpu")
        assert len(list(stream.stream(src[:1], pun[:1], style[:1]))) > 1
    model = str(tmp_path / "m.gguf")
    tparams.save_params(model, pt, CFG)
    assert cli.main(["--model", model, "--demo", "--output", str(tmp_path / "o.wav"),
                     "--device", "cpu"]) == 0
    server = TTSServer(pt, CFG, port=0, warmup=False, device="cpu")
    server.start()
    try:
        wav, _ = TTSClient(*server.address).synthesize(src[0], style[0], pun[0])
        assert len(wav) > 0
    finally:
        server.shutdown()
