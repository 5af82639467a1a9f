"""Training checkpoint / resume, and the weights-only GGUF export for serving.

The port of zerovox_tpu/training/checkpoint.py, with torch.save in place of
orbax.  A checkpoint is the whole TrainState (params, the optimizer's
moments and count, the step) as one file per step, `step_<N>.pt`, in the
manager's directory.  `save` copies the state to the host and hands the
write to one writer thread, so a training loop waits for the device copy
but not for the disk; each write goes to a temporary file in the same
directory that is then renamed over the final name, so a file of that name
is always whole.  Keep-last-N retention deletes the older steps' files.

A sharded state (make_sharded_train_step) is saved whole: its pieces are
gathered into the full parameter tree and the full Adam moments on the
host, so a checkpoint does not depend on the mesh it was made on, and
restores onto any mesh (the pieces cut from the whole tensors are the same
bits).  In a run of several processes one process writes (the training
CLI's rank 0).
"""

from __future__ import annotations

import os
import re
import tempfile
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional

import torch

from ..params import save_params, tree_map
from .train import TrainState

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    """Step-numbered TrainState checkpoints with keep-last-N retention."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1 (got {max_to_keep})")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="zv-ckpt")
        self._pending: List[Future] = []
        self._lock = threading.Lock()

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def steps(self) -> List[int]:
        """The steps with a whole checkpoint on disk, ascending (a write still
        in flight is not one)."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, state: TrainState, step: Optional[int] = None, wait: bool = False) -> int:
        """Save `state` as step `step` (default state.step); returns the step.
        The state is copied to the host here; the file is written by the
        writer thread, or before returning with wait=True."""
        step = int(state.step) if step is None else int(step)
        host = tree_map(lambda t: t.detach().cpu() if torch.is_tensor(t) else t,
                        {"params": _whole(state.params, state.params),
                         "opt_state": _whole(state.opt_state, state.params),
                         "step": int(state.step)})
        future = self._writer.submit(self._write, host, step)
        with self._lock:
            self._pending.append(future)
        if wait:
            self.wait_until_finished()
        return step

    def _write(self, host: dict, step: int):
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=f".step_{step}.", suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(host, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path(step))
        except BaseException:
            os.unlink(tmp)
            raise
        for old in self.steps()[:-self.max_to_keep]:
            os.unlink(self.path(old))

    def wait_until_finished(self):
        """Block until every save so far is on disk; raises a write's error."""
        with self._lock:
            pending, self._pending = self._pending, []
        for future in pending:
            future.result()

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, target: TrainState, step: Optional[int] = None) -> TrainState:
        """The checkpoint of `step` (default the latest) in the structure of
        `target` (e.g. make_train_step's fresh state), its tensors placed on
        the devices and in the dtypes of target's.  A checkpoint of another
        structure or shape raises ValueError."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        self.wait_until_finished()
        saved = torch.load(self.path(step), map_location="cpu", weights_only=True)
        layout = getattr(target.params, "layout", None)
        if layout is None:
            params = _into(target.params, saved["params"], "params")
            opt_state = _into(target.opt_state, saved["opt_state"], "opt_state")
            return TrainState(params, opt_state, int(saved["step"]))
        # a sharded target: the whole trees checked against its shapes, then cut
        shapes = layout.template
        params = layout.scatter(_into(shapes, saved["params"], "params"))
        opt_state = _into({k: shapes if _param_shaped(v, target.params) else v
                           for k, v in target.opt_state.items()},
                          saved["opt_state"], "opt_state")
        opt_state = {k: dict(layout.scatter(v)) if _param_shaped(target.opt_state[k], target.params)
                     else v for k, v in opt_state.items()}
        return TrainState(params, opt_state, int(saved["step"]))

    def close(self):
        try:
            self.wait_until_finished()
        finally:
            self._writer.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _param_shaped(node, params) -> bool:
    """Whether an optimizer-state entry is a tree like the params (a moment)."""
    return isinstance(node, dict) and node.keys() == params.keys()


def _whole(tree, params):
    """A state's params, or its optimizer state, with a sharded state's
    pieces gathered into whole tensors (on the host); anything else as it is."""
    layout = getattr(params, "layout", None)
    if layout is None:
        return tree
    if tree is params:
        return layout.gather(tree)
    return {k: layout.gather(v) if _param_shaped(v, params) else v for k, v in tree.items()}


def _into(template, saved, where: str):
    """`saved` (a host tree) laid out as `template`: same keys, lengths and
    tensor shapes, tensors moved to the template's device and dtype (kept on
    the host for a template on the meta device)."""
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError(f"checkpoint {where}: its keys do not match the template's "
                             f"{sorted(template)}")
        return {k: _into(v, saved[k], f"{where}.{k}") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(template):
            raise ValueError(f"checkpoint {where}: not a list of {len(template)}")
        return [_into(v, s, f"{where}[{i}]") for i, (v, s) in enumerate(zip(template, saved))]
    if torch.is_tensor(template):
        if not torch.is_tensor(saved) or saved.shape != template.shape:
            got = tuple(saved.shape) if torch.is_tensor(saved) else type(saved).__name__
            raise ValueError(f"checkpoint {where}: {got}, the template's "
                             f"{tuple(template.shape)}")
        if template.device.type == "meta":
            return saved.to(template.dtype)
        return saved.to(template.device, template.dtype)
    return type(template)(saved)


def export_weights_gguf(path: str, state: TrainState, cfg):
    """Serving export: the weights alone, as a GGUF in the reference's
    format (params.save_params; the JAX package's export of the same
    weights is the same file).  A sharded state is gathered first."""
    save_params(path, _whole(state.params, state.params), cfg)
