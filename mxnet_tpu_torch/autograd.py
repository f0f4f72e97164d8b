"""Autograd mode state: training and recording flags and their scopes.

Counterpart of the state half of ``mxnet_tpu/autograd.py`` (its l.35-96):
``is_training``/``set_training``, ``is_recording``/``set_recording``,
``pause`` and ``predict_mode``.  Both flags are thread-local, as in the
JAX package, so a worker thread starts in predict mode, not recording.
The tape (``record``, ``backward``, ``mark_variables``) comes with the
training port.
"""
from __future__ import annotations

import threading
from typing import Optional

__all__ = ["pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(flag: bool) -> bool:
    prev, _STATE.recording = _STATE.recording, bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    prev, _STATE.training = _STATE.training, bool(flag)
    return prev


class _Scope:
    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._rec, self._train = recording, training

    def __enter__(self):
        if self._rec is not None:
            self._prev_rec = set_recording(self._rec)
        if self._train is not None:
            self._prev_train = set_training(self._train)
        return self

    def __exit__(self, *a):
        if self._rec is not None:
            set_recording(self._prev_rec)
        if self._train is not None:
            set_training(self._prev_train)
        return False


def pause(train_mode: bool = False) -> _Scope:
    return _Scope(False, train_mode)


def train_mode() -> _Scope:
    return _Scope(None, True)


def predict_mode() -> _Scope:
    return _Scope(None, False)
