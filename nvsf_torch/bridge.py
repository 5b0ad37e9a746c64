"""Interchange between nvsf_tpu's state (params trees with numpy leaves, as
``NVSFFieldSpec.init`` returns them or ``train/checkpoint.py`` pickles them)
and the port's modules and trainer state.

Parameter names of ``NVSFField`` are the tree's paths joined by dots, without
the ``w`` key of an MLP layer: ``planes_lidar.<scale>.<plane>``,
``hash_lidar.static``, ``flow.grid``, ``flow.mlp.<layer>``,
``sigma_net.<layer>`` and so on. Layouts are the same on both sides, so
the conversion copies values bit for bit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from nvsf_torch.models.field import NVSFField

_HASH_KEYS = ("static", "dyn_xyt", "dyn_xzt", "dyn_yzt")
_MLPS = ("sigma_net", "intensity_net", "raydrop_net", "color_net")


def flatten_tree(tree) -> Dict[str, np.ndarray]:
    """JAX params tree -> {port parameter name: numpy array}."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path if k == "w" else path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out[".".join(path)] = np.asarray(node)

    walk(tree, ())
    return out


def params_from_tree(tree, device=None) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.array(v), device=device)
            for k, v in flatten_tree(tree).items()}


@torch.no_grad()
def load_field(field: NVSFField, tree) -> None:
    """Copy a JAX params tree into the field's parameters (exact names and
    shapes required)."""
    flat = flatten_tree(tree)
    own = dict(field.named_parameters())
    if set(flat) != set(own):
        raise KeyError(f"params tree does not match the field: missing "
                       f"{sorted(set(own) - set(flat))}, unexpected "
                       f"{sorted(set(flat) - set(own))}")
    for k, p in own.items():
        if tuple(flat[k].shape) != tuple(p.shape):
            raise ValueError(f"{k}: tree shape {flat[k].shape} != "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(flat[k])))


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy: a CPU tensor's ``numpy()`` would alias the live values."""
    return t.detach().cpu().numpy().copy()


def tree_from_params(params: Dict[str, torch.Tensor]):
    """{port parameter name: tensor} (``named_parameters`` or the EMA) ->
    a JAX-layout params tree with numpy leaves."""
    def scales(prefix):
        out, si = [], 0
        while f"{prefix}.{si}.0" in params:
            out.append([_np(params[f"{prefix}.{si}.{ci}"])
                        for ci in range(6)])
            si += 1
        return out

    def mlp(prefix):
        out, li = [], 0
        while f"{prefix}.{li}" in params:
            out.append({"w": _np(params[f"{prefix}.{li}"])})
            li += 1
        return out

    tree = {}
    for br in ("lidar", "camera"):
        tree[f"planes_{br}"] = scales(f"planes_{br}")
        tree[f"hash_{br}"] = {k: _np(params[f"hash_{br}.{k}"])
                              for k in _HASH_KEYS}
    tree["flow"] = {"grid": _np(params["flow.grid"]),
                    "mlp": mlp("flow.mlp")}
    for k in _MLPS:
        tree[k] = mlp(k)
    return tree


def field_to_tree(field: NVSFField):
    return tree_from_params(dict(field.named_parameters()))


# trainer state <-> checkpoint payload (``nvsf_tpu/train/checkpoint.py``):
# payload keys of the arrays that are not parameters
_STATE_ARRAYS = ("error_map", "error_map_rgb", "occ_grid_lidar",
                 "occ_grid_rgb")


@torch.no_grad()
def load_trainer_state(trainer, payload: dict) -> None:
    """Load params, EMA, occupancy grids and error maps into a port
    ``Trainer``. ``payload`` is a checkpoint payload (``model``, ``ema``,
    ...) or a JAX ``Trainer.state`` (``params``, ``ema_params``, ...)."""
    model = payload.get("model", payload.get("params"))
    load_field(trainer.field, model)
    ema = payload.get("ema", payload.get("ema_params"))
    if ema is not None:
        for k, v in params_from_tree(ema, trainer.device).items():
            trainer.ema[k].copy_(v)
    for k in _STATE_ARRAYS:
        if payload.get(k) is not None and getattr(trainer, k) is not None:
            getattr(trainer, k).copy_(torch.as_tensor(
                np.asarray(payload[k]), device=trainer.device))
    if "global_step" in payload:
        trainer.global_step = int(payload["global_step"])


def export_trainer_state(trainer) -> dict:
    """The inverse of ``load_trainer_state``, as a checkpoint payload with
    numpy leaves."""
    out = {"model": field_to_tree(trainer.field),
           "ema": tree_from_params(trainer.ema),
           "global_step": trainer.global_step}
    for k in _STATE_ARRAYS:
        v = getattr(trainer, k)
        out[k] = None if v is None else _np(v)
    return out
