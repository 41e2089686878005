"""Result persistence and training-state checkpoints.

Counterpart of the JAX package's ``utils/io.py``:

* :func:`save_results` / :func:`load_results`: named arrays as one
  compressed ``.npz`` (each tensor fetched to the host once); files written
  by the JAX package's ``save_results`` load the same way.
* :func:`save_train_state` / :func:`restore_train_state`: ``torch.save`` of
  a nest of tensors (dicts, lists, tuples, NamedTuples such as
  ``CalibrationParams``, an optimizer's ``state_dict()``) and
  ``torch.load(weights_only=True)`` back.  Only tensors, numbers, strings,
  bools and None are stored: no arbitrary object is pickled.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

__all__ = [
    "save_results",
    "load_results",
    "save_train_state",
    "restore_train_state",
]


def save_results(path, **arrays) -> pathlib.Path:
    """Save named arrays (tensors on any device, numpy, lists) as one
    compressed ``.npz``; returns the path."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    host = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in arrays.items()}
    np.savez_compressed(path, **host)
    return path


def load_results(path) -> dict:
    """The named arrays of a ``.npz`` as host numpy arrays."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


_LEAVES = (bool, int, float, str, type(None))


def _plain(state, where: str = "state"):
    """``state`` as dicts, lists and tuples of tensors and plain values
    (a NamedTuple becomes a dict of its fields); anything else raises."""
    if isinstance(state, torch.Tensor):
        return state.detach()
    if isinstance(state, _LEAVES):
        return state
    if isinstance(state, tuple) and hasattr(state, "_asdict"):
        return {k: _plain(v, f"{where}.{k}") for k, v in state._asdict().items()}
    if isinstance(state, dict):
        return {k: _plain(v, f"{where}[{k!r}]") for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_plain(v, f"{where}[{i}]") for i, v in enumerate(state))
    raise TypeError(f"{where}: {type(state).__name__} is not a tensor, number, string or "
                    "container of them; save_train_state pickles no other object")


def save_train_state(path, state) -> pathlib.Path:
    """Checkpoint a nest of tensors (parameters and an optimizer's
    ``state_dict()``) with ``torch.save``; returns the path."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_plain(state), path)
    return path


def _first_tensor(like):
    if isinstance(like, torch.Tensor):
        return like
    values = like.values() if isinstance(like, dict) else (
        like if isinstance(like, (list, tuple)) else ())
    for v in values:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def _rebuild(loaded, like, device):
    """``loaded`` in ``like``'s structure: NamedTuples rebuilt, tensors in
    ``like``'s dtype and device; entries ``like`` lacks (an optimizer's
    per-parameter state before its first step) keep their own dtype and go
    to ``device``."""
    if isinstance(loaded, torch.Tensor):
        if isinstance(like, torch.Tensor):
            return loaded.to(device=like.device, dtype=like.dtype)
        return loaded.to(device)
    if isinstance(like, tuple) and hasattr(like, "_asdict") and isinstance(loaded, dict):
        return type(like)(**{k: _rebuild(loaded[k], v, device)
                             for k, v in like._asdict().items()})
    if isinstance(loaded, dict):
        like = like if isinstance(like, dict) else {}
        return {k: _rebuild(v, like.get(k), device) for k, v in loaded.items()}
    if isinstance(loaded, (list, tuple)):
        likes = like if isinstance(like, (list, tuple)) and len(like) == len(loaded) else (
            (None,) * len(loaded))
        return type(loaded)(_rebuild(v, lk, device) for v, lk in zip(loaded, likes))
    return loaded


def restore_train_state(path, like):
    """Restore a checkpoint of :func:`save_train_state`.  ``like`` gives the
    structure (NamedTuples, dicts) and the device: the first tensor in it,
    else the CPU."""
    first = _first_tensor(like)
    device = first.device if first is not None else torch.device("cpu")
    loaded = torch.load(pathlib.Path(path), map_location=device, weights_only=True)
    return _rebuild(loaded, like, device)
