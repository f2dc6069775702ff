"""Checkpoint and resume of training state (port of
``volume_renderer_tpu.utils.checkpoint``).

The parameters (a dict of tensors, as ``train.split_params`` gives them,
or nested dicts and lists of them, as the brick path's), the optimizer's
``state_dict()`` and the step counter go into one ``.npz`` file, written
atomically. Entries are named by their key paths the way the JAX package
names them (``jax.tree_util.keystr``): ``params['emission']``,
``opt['state'][0]['exp_avg']``. So the parameters of a checkpoint that the
JAX package wrote load into the port. Its optimizer state does not: optax
keeps another state than ``torch.optim``; load such a file with
``optimizer=None``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_STEP = "__step__"
_GROUPS = "opt['param_groups']"
_STATE = "opt['state']"
_KEY = re.compile(r"\[('(?:[^'\\]|\\.)*'|-?\d+)\]")


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, Any]]:
    """(key path, leaf) of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _as_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, params, optimizer: Optional[torch.optim.Optimizer],
                    step: int) -> None:
    """Atomically writes (params, the optimizer's state, step) to ``path``
    (.npz): a temporary file, then ``os.replace``."""
    payload: Dict[str, np.ndarray] = {}
    for key_path, leaf in _leaves(params):
        payload["params" + _keystr(key_path)] = _as_array(leaf)
    if optimizer is not None:
        state = optimizer.state_dict()
        for key_path, leaf in _leaves(state["state"]):
            if leaf is not None:
                payload[_STATE + _keystr(key_path)] = _as_array(leaf)
        payload[_GROUPS] = np.asarray(json.dumps(state["param_groups"]))
    payload[_STEP] = np.asarray(step, np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def _parse(keys: str) -> tuple:
    return tuple(k[1:-1] if k.startswith("'") else int(k) for k in _KEY.findall(keys))


def load_checkpoint(path: str, params, optimizer: Optional[torch.optim.Optimizer] = None):
    """Restores a checkpoint into ``params`` (copied in place, under no_grad)
    and ``optimizer`` (``load_state_dict``; None leaves it out). Returns
    (params, optimizer, step). Raises ``KeyError`` naming the first entry
    that ``params`` or the optimizer needs and the file lacks, and
    ``ValueError`` for a parameter of another shape."""
    with np.load(path) as data:
        with torch.no_grad():
            for key_path, leaf in _leaves(params):
                key = "params" + _keystr(key_path)
                if key not in data:
                    raise KeyError(f"checkpoint {path} has no entry {key}")
                value = torch.from_numpy(data[key])
                if tuple(value.shape) != tuple(leaf.shape):
                    raise ValueError(f"checkpoint {path}: {key} is {tuple(value.shape)}, the "
                                     f"parameter {tuple(leaf.shape)}")
                leaf.copy_(value)
        if optimizer is not None:
            if _GROUPS not in data:
                raise KeyError(f"checkpoint {path} has no entry {_GROUPS} (a torch.optim "
                               f"state; a JAX package checkpoint holds an optax one)")
            state: Dict = {}
            for key in data.files:
                if key.startswith(_STATE):
                    *parents, last = _parse(key[len(_STATE):])
                    node = state
                    for k in parents:
                        node = node.setdefault(k, {})
                    node[last] = torch.from_numpy(data[key])
            groups = json.loads(str(data[_GROUPS]))
            if len(groups) != len(optimizer.param_groups):
                raise KeyError(f"checkpoint {path} has {len(groups)} parameter groups, the "
                               f"optimizer {len(optimizer.param_groups)}")
            optimizer.load_state_dict({"state": state, "param_groups": groups})
        step = int(data[_STEP])
    return params, optimizer, step
