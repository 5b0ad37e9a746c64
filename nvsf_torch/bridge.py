"""Interchange between nvsf_tpu's state (params trees with numpy leaves, as
``NVSFFieldSpec.init`` returns them or ``train/checkpoint.py`` pickles them)
and the port's modules and trainer state: the field, its EMA, the U-Net,
the Adam state, the occupancy grids and error maps.

Parameter names of ``NVSFField`` are the tree's paths joined by dots, without
the ``w`` key of an MLP layer: ``planes_lidar.<scale>.<plane>``,
``hash_lidar.static``, ``flow.grid``, ``flow.mlp.<layer>``,
``sigma_net.<layer>`` and so on. Layouts are the same on both sides, so
the conversion copies values bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional

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


# ----------------------------------------------------------------------
# the U-Net (``nvsf_tpu/models/unet.py``): params and BN statistics trees,
# nested dicts whose dotted paths are the module's parameter and buffer
# names
# ----------------------------------------------------------------------

def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def unet_to_trees(unet) -> tuple:
    """(params tree, stats tree) of a ``UNet``, numpy leaves."""
    return (_unflatten({k: _np(v) for k, v in unet.named_parameters()}),
            _unflatten({k: _np(v) for k, v in unet.named_buffers()}))


@torch.no_grad()
def load_unet(unet, params_tree, stats_tree) -> None:
    """Copy JAX U-Net params and stats trees into ``unet`` (exact names and
    shapes required)."""
    for tree, own in ((params_tree, dict(unet.named_parameters())),
                      (stats_tree, dict(unet.named_buffers()))):
        flat = flatten_tree(tree)
        if set(flat) != set(own):
            raise KeyError(f"U-Net tree does not match: missing "
                           f"{sorted(set(own) - set(flat))}, unexpected "
                           f"{sorted(set(flat) - set(own))}")
        for k, t in own.items():
            if tuple(flat[k].shape) != tuple(t.shape):
                raise ValueError(f"{k}: tree shape {flat[k].shape} != "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(flat[k])))


# ----------------------------------------------------------------------
# Adam state. torch's Adam and the chain of the JAX package's
# ``make_optimizer`` keep the same moments: ``ScaleByAdamState`` (count,
# mu, nu) is torch's (step, exp_avg, exp_avg_sq), mu and nu being params
# trees, and the schedule follows the global step in both.
# ----------------------------------------------------------------------

@torch.no_grad()
def _set_adam_state(trainer, step: int, exp_avg: dict, exp_avg_sq: dict):
    params = dict(trainer.field.named_parameters())
    if set(exp_avg) != set(params) or set(exp_avg_sq) != set(params):
        raise KeyError("optimizer state does not match the field's "
                       "parameters")
    # capturable Adam (on the card) keeps its step count on the device
    capturable = trainer.optimizer.defaults.get("capturable", False)
    for k, p in params.items():
        trainer.optimizer.state[p] = {
            "step": torch.tensor(float(step),
                                 device=p.device if capturable else None),
            "exp_avg": torch.as_tensor(np.array(exp_avg[k]),
                                       device=p.device),
            "exp_avg_sq": torch.as_tensor(np.array(exp_avg_sq[k]),
                                          device=p.device)}


def _optax_adam(opt_state):
    """The ``ScaleByAdamState`` of an optax chain state, live or as the
    checkpoint loader's stand-in."""
    for s in opt_state:
        if type(s).__name__ == "ScaleByAdamState":
            return s
    raise ValueError("opt_state holds no ScaleByAdamState: not the chain "
                     "of nvsf_tpu.train.trainer.make_optimizer")


def _torch_adam_state(trainer) -> Optional[dict]:
    """The port's Adam state by parameter name (None before a step)."""
    state = trainer.optimizer.state
    params = dict(trainer.field.named_parameters())
    if not any(p in state for p in params.values()):
        return None
    return {"step": int(state[params[next(iter(params))]]["step"]),
            "exp_avg": {k: _np(state[p]["exp_avg"])
                        for k, p in params.items()},
            "exp_avg_sq": {k: _np(state[p]["exp_avg_sq"])
                           for k, p in params.items()}}


# trainer state <-> checkpoint payload (``nvsf_tpu/train/checkpoint.py``):
# payload keys of the arrays that are not parameters
_STATE_ARRAYS = ("error_map", "error_map_rgb", "occ_grid_lidar",
                 "occ_grid_rgb")


@torch.no_grad()
def load_trainer_state(trainer, payload: dict) -> None:
    """Load params, EMA, occupancy grids, error maps, the U-Net and the
    optimizer state into a port ``Trainer``. ``payload`` is a checkpoint
    payload of either package (``model``, ``ema``, ``unet``, ...,
    ``opt_state_torch`` or optax's ``opt_state``) or a JAX
    ``Trainer.state`` (``params``, ``ema_params``, ``unet_params``, ...).
    A ``global_step`` also sets the learning-rate schedule. The trainer's
    captured steps are dropped: they read the tensors this replaces."""
    trainer.drop_step_graphs()
    model = payload.get("model", payload.get("params"))
    load_field(trainer.field, model)
    ema = payload.get("ema", payload.get("ema_params"))
    if ema is not None:
        for k, v in params_from_tree(ema, trainer.device).items():
            trainer.ema[k].copy_(v)
    # replaced, not copied into: a test scene (novel sensor) loads the
    # training run's error maps, of other frames and resolutions
    for k in _STATE_ARRAYS:
        if payload.get(k) is not None and getattr(trainer, k) is not None:
            setattr(trainer, k, torch.as_tensor(
                np.array(payload[k], np.float32), device=trainer.device))
    unet = payload.get("unet", payload.get("unet_params"))
    if unet is not None:
        load_unet(trainer.unet, unet, payload["unet_stats"])
    if payload.get("opt_state_torch") is not None:
        st = payload["opt_state_torch"]
        _set_adam_state(trainer, st["step"], st["exp_avg"],
                        st["exp_avg_sq"])
    elif payload.get("opt_state") is not None:
        count, mu, nu = _optax_adam(payload["opt_state"])
        _set_adam_state(trainer, int(np.asarray(count)), flatten_tree(mu),
                        flatten_tree(nu))
    if "global_step" in payload:
        trainer.global_step = int(payload["global_step"])
        trainer.set_schedule(trainer.global_step)
    for k in ("epoch", "stats", "unet_trained"):
        if k in payload:
            setattr(trainer, k, payload[k])


def export_trainer_state(trainer, full: bool = True) -> dict:
    """The checkpoint payload of a port ``Trainer``, numpy leaves in the
    JAX package's layout; ``full`` adds the error maps and the optimizer
    state (``opt_state_torch``)."""
    unet, unet_stats = unet_to_trees(trainer.unet)
    out = {"model": field_to_tree(trainer.field),
           "ema": tree_from_params(trainer.ema),
           "unet": unet, "unet_stats": unet_stats,
           "unet_trained": bool(trainer.unet_trained),
           "epoch": trainer.epoch, "global_step": trainer.global_step,
           "stats": trainer.stats}
    for k in _STATE_ARRAYS:
        if full or k.startswith("occ_grid"):
            v = getattr(trainer, k)
            out[k] = None if v is None else _np(v)
    if full:
        out["opt_state_torch"] = _torch_adam_state(trainer)
    return out
