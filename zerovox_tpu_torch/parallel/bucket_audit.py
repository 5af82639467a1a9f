"""A serving engine's answers held against one device's, bucket by bucket.

A sharded engine computes the front (encoder, variance adaptor, length
regulator, decoder) in another order of float sums than one device at
B=1: under TP the row-parallel sums are split over the model axis, under
DP each data device runs its slice of the batch at another batch size (its
convolutions may take other algorithms).  A pitch or energy prediction
within float rounding of a bucket edge can then fall into the neighbouring
bucket (a frame count can move the same way), and from there on the
utterance is another input to the decoder: its waveform is not the
one-device waveform within any float gate.

engine_audit (audit_fronts on engine_fronts) names every such move;
hold_answers checks that each is float order (its two predictions within
FLIP_DELTA) and holds that answer against the one-device back end
continuing the engine's front instead, and every other answer against one
device at the caller's gate (TP_TOL, the JAX package's TP gate, for TP).
variance_of taps a front; energy_after and back_from continue one on one
device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..models import fs2_encoder, hifigan, styletts_decoder
from ..models.pipeline import front
from ..ops import durations_from_log, length_regulate
from ..ops.misc import bucketize
from ..utils.debug import capture_run
from .mesh import DATA_AXIS, MODEL_AXIS
from .sharding import param_partition_specs
from .tp import front_tp, tp_view

TP_TOL = dict(atol=2e-4, rtol=1e-3)       # f32 TP against one device (the JAX tests' gate)
# a prediction this close to one device's (on the same input to the bit
# where a pitch bucket moved: energy_after) differs by the order of float
# sums only; set from chip_smoke.py phase 9's readings on an H100 (the
# largest gap under f32 TP and that with TF32 products, printed at the end
# of the phase; PERF.md)
FLIP_DELTA = 1e-4


def variance_of(cfg, front_fn: Callable, rows) -> List[dict]:
    """Per utterance of the row blocks `rows` ((src, pun, style, lens) on a
    device), what front_fn(*row) tapped (utils.debug.capture_run): the pitch
    and energy predictions, the log-durations and the frame counts, as
    numpy, cut to the utterance's phonemes; and under "front" the tensors a
    one-device back end and energy predictor need to continue from this
    front (its encoder output, pitch, features, log-durations, style and
    phoneme count, on the device that computed them)."""
    out = []
    for row in rows:
        _, taps = capture_run(front_fn, *row)
        frames = durations_from_log(taps["log_duration"], cfg.max_seq_len)
        for b, n in enumerate(row[3].tolist()):
            u = {k: t[b, :n].float().cpu().numpy() for k, t in
                 (("pitch", taps["pitch"]), ("energy", taps["energy"]), ("frames", frames),
                  ("log_duration", taps["log_duration"]))}
            u["front"] = {k: taps[k][b:b + 1] for k in
                          ("encoder_output", "pitch", "features", "log_duration")}
            u["front"].update(style=row[2][b:b + 1], num_phonemes=row[3][b:b + 1])
            out.append(u)
    return out


def energy_after(cfg, model, fr: dict) -> torch.Tensor:
    """The one-device energy predictor on the pitch-updated features of the
    front `fr` (variance_of's "front"): encode's own steps from that
    front's encoder output and pitch buckets, so the input is that front's
    to the bit and only the predictor's sums differ."""
    enc, dev = model.params["encoder"], model.device
    x = fr["encoder_output"].to(dev)
    features = x + fr["style"].to(dev)[:, None, :].to(x.dtype)
    features = features + enc["pitch_emb"][bucketize(fr["pitch"].to(dev), cfg.ve_n_bins)].to(x.dtype)
    return fs2_encoder.variance_predictor(features, enc["energy_predictor"], cfg)


def back_from(cfg, model, fr: dict) -> Dict[str, np.ndarray]:
    """The one-device length regulator, decoder and vocoder (packed weights)
    continuing the front `fr`: (mel, wav) of one utterance, as numpy, the
    full max_seq_len buffer."""
    dev = model.device
    with torch.inference_mode():
        durations = durations_from_log(fr["log_duration"].to(dev), cfg.max_seq_len)
        hidden, _ = length_regulate(fr["features"].to(dev), durations, cfg.max_seq_len,
                                    num_phonemes=fr["num_phonemes"].to(dev))
        mel = styletts_decoder.decode(model.params, cfg, hidden, fr["style"].to(dev))
        wav = hifigan.vocode(model.params, cfg, mel, model.packed)
    return {"mel": mel[0].float().cpu().numpy(), "wav": wav[0].float().cpu().numpy()}


def audit_fronts(cfg, model, got: List[dict], want: List[dict],
                 gaps: Optional[Dict[str, float]] = None):
    """An engine's front's variance_of (`got`) against one device's (`want`,
    on `model`, a LoadedModel): per utterance the pitch or energy buckets
    and frame counts that moved, [(what, phoneme, one device -> engine,
    |engine - one device| of the prediction (the log-duration for a frame
    count))], and for an utterance with a move, the one-device back end
    continuing the engine's front (back_from), which its answer is held
    against.  Where a pitch bucket moved, the energy is held against the
    one-device predictor on the engine's pitch-updated features
    (energy_after).  The largest gap per prediction goes to `gaps`
    ({"pitch", "energy", "log_duration"}).  Returns (moves, anchors)."""
    def buckets(v):
        return bucketize(torch.as_tensor(v), cfg.ve_n_bins).numpy()
    moves, anchors = [], {}
    for u, (g, w) in enumerate(zip(got, want)):
        f = []
        ref = {"pitch": w["pitch"], "energy": w["energy"], "log_duration": w["log_duration"]}
        if (buckets(g["pitch"]) != buckets(w["pitch"])).any():
            with torch.inference_mode():
                ref["energy"] = energy_after(cfg, model, g["front"])[0, :len(g["energy"])] \
                    .float().cpu().numpy()
        for k in ("pitch", "energy"):
            bg, bw = buckets(g[k]), buckets(w[k])
            f += [(k, int(p), int(bw[p]), int(bg[p]), abs(float(g[k][p] - ref[k][p])))
                  for p in np.flatnonzero(bg != bw)]
        f += [("frames", int(p), int(w["frames"][p]), int(g["frames"][p]),
               abs(float(g["log_duration"][p] - w["log_duration"][p])))
              for p in np.flatnonzero(g["frames"] != w["frames"])]
        for k in gaps or {}:
            gaps[k] = max(gaps[k], float(np.abs(g[k] - ref[k]).max(initial=0)))
        if f:
            anchors[u] = back_from(cfg, model, g["front"])
        moves.append(f)
    return moves, anchors


def engine_fronts(cfg, engine, batch) -> List[dict]:
    """variance_of of each utterance of `batch` ((src, pun, style, lens) as
    numpy) as `engine` computes its front: ladder-padded, split over the
    data axis, each data row's front on its own devices (a TTSEngine, on
    one device or a pure-DP mesh: `front` on that row's replica; a
    TPServingEngine: the channel-sharded `front_tp` over the row's model
    devices)."""
    mesh = engine.mesh
    n = 1 if mesh is None else mesh.shape[DATA_AXIS]
    tp = mesh is not None and mesh.shape[MODEL_AXIS] > 1
    specs = param_partition_specs(engine.model.params) if tp else None
    out = []
    for padded, real in engine._ladder_chunks(range(len(batch[0]))):
        # the ladder-padded rows (the first `real` are the request's), split
        # over the data axis as the engine splits them
        for i, pos in enumerate(np.array_split(np.arange(len(padded)), n)):
            idx = np.asarray(padded)[pos]
            if tp:
                view = tp_view([m.params for m in engine.params[i]], specs)
                fn, dev = (lambda *r: front_tp(view, cfg, *r)), engine.params[i, 0].device
            else:
                replica = engine._models[i]
                fn, dev = (lambda *r: front(replica.params, cfg, *r)), replica.device
            row = tuple(torch.as_tensor(np.asarray(a)[idx], device=dev).to(t) for a, t in
                        zip(batch, (torch.long, torch.long, torch.float32, torch.long)))
            out += [u for u, p in zip(variance_of(cfg, fn, [row]), pos) if p < real]
    return out


def engine_audit(cfg, engine, single, batch, gaps: Optional[Dict[str, float]] = None):
    """audit_fronts of `engine`'s fronts for `batch` against those of
    `single`, a one-device TTSEngine, on the same batch (each as it runs
    it: engine_fronts); the back ends continue on single's model."""
    return audit_fronts(cfg, single.model, engine_fronts(cfg, engine, batch),
                        engine_fronts(cfg, single, batch), gaps)


def hold_answers(got, want, audit, what: str, key: str, gate: dict,
                 log: Callable[[str], None] = print,
                 counts: Optional[Dict[str, int]] = None) -> str:
    """An engine's answers (per-utterance arrays, `key` "mel" or "wav")
    against the single device's.  Where no bucket or frame count moved
    (audit_fronts), within `gate` (np.allclose keywords).  Where one moved,
    the utterance is another input to the decoder from there on: each move
    must be float order (its two predictions within FLIP_DELTA), and the
    answer is held at the same gate against the one-device back end
    continuing the engine's front; every move is named through `log`, with
    the answer's distance from the one-device answer.  Raises RuntimeError
    on an answer beyond its gate or a move beyond FLIP_DELTA.  The
    utterance counts go to `counts` ({"same", "moved"}); returns a line
    that describes the hold."""
    moves, anchors = audit
    same, moved = [], []
    for u, (g, w, f) in enumerate(zip(got, want, moves)):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        d = float(np.abs(g - w).max(initial=0)) if g.shape == w.shape else None
        ref = anchors[u][key][:len(g)] if f else w
        if (g.shape != ref.shape or not np.isfinite(g).all()
                or not np.allclose(g, ref, **gate)):
            raise RuntimeError(f"{what}: utterance {u} differs from "
                               + ("the one-device back end on the engine's front" if f else
                                  "one device, every bucket as there")
                               + f": max|d| {np.abs(g - ref).max() if g.shape == ref.shape else None}"
                               f" (gate {gate})")
        if not f:
            same.append(d)
            continue
        d_back = float(np.abs(g - ref).max(initial=0))
        log(f"  {what}: utterance {u}: {len(f)} bucket or frame count(s) moved against one "
            "device ("
            + "; ".join(f"{k} of phoneme {p}: {a} -> {b}, predictions {e:.1e} apart"
                        for k, p, a, b, e in f[:4])
            + f"{' ...' if len(f) > 4 else ''}); max|d| {d_back:.3e} from the one-device back "
            f"end on the engine's front; "
            + (f"{d:.3e} from one device" if d is not None else "another length than one device"))
        unexplained = [x for x in f if x[4] > FLIP_DELTA]
        if unexplained:
            raise RuntimeError(f"{what}: utterance {u}: a bucket moved by more than float "
                               f"order: {unexplained}")
        moved.append(d_back)
    if counts is not None:
        counts["same"] += len(same)
        counts["moved"] += len(moved)
    return (f"{len(same)} utterance(s) with every bucket as on one device within {gate}: "
            f"max|d| {max(same, default=0.0):.3e}; {len(moved)} with a moved bucket, within "
            f"it of the one-device back end on the engine's front: max|d| "
            f"{max(moved, default=0.0):.3e}")
