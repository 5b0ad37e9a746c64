"""The bridge between nvsf_tpu's params trees and the port, and the port's
independence from JAX."""

import ast
import os
import subprocess
import sys

import jax
import numpy as np

from nvsf_tpu.models.field import NVSFFieldSpec
from nvsf_torch import bridge
from nvsf_torch.models.field import FieldSpec, NVSFField

from test_torch_models import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = dict(n_levels_hash=4, n_features_per_level_hash=8,
            log2_hashmap_size=12, hash_size_dynamic=(11, 10, 10),
            flow_n_levels=4, flow_log2_hashmap_size=10, num_frames=4)


def _assert_trees_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_init_tree_round_trips_bit_exactly():
    tree = jax.tree.map(np.asarray,
                        NVSFFieldSpec(**SPEC).init(jax.random.PRNGKey(0)))
    field = NVSFField(FieldSpec(**SPEC))
    bridge.load_field(field, tree)
    _assert_trees_equal(bridge.field_to_tree(field), tree)


def test_trainer_state_round_trips():
    """Params, EMA, occupancy grids and error maps of a checkpoint payload
    (``nvsf_tpu/train/checkpoint.py`` layout) load and export unchanged."""
    from nvsf_torch.config import NVSFConfig
    from nvsf_torch.data.synthetic import (SyntheticSceneSpec,
                                           make_synthetic_scene)
    from nvsf_torch.train.trainer import Trainer

    scene = make_synthetic_scene(SyntheticSceneSpec(
        num_frames=4, H_lidar=8, W_lidar=16, H=8, W=8, max_depth=25.0))
    s = 1 / 26
    cfg = NVSFConfig.from_dict(dict(
        enable_lidar=True, enable_rgb=True, scale=s,
        min_near_lidar=0.5 * s, lidar_max_depth=25.0 * s, min_near=0.5 * s,
        render_mode="occupancy", occ_grid_size=8, bound=1.0, **SPEC))
    tr = Trainer(cfg, scene, device="cpu")
    rng = np.random.default_rng(0)
    jspec = NVSFFieldSpec(**SPEC)
    payload = {
        "model": jax.tree.map(np.asarray, jspec.init(jax.random.PRNGKey(1))),
        "ema": jax.tree.map(np.asarray, jspec.init(jax.random.PRNGKey(2))),
        "global_step": 7,
    }
    for k in ("error_map", "error_map_rgb", "occ_grid_lidar",
              "occ_grid_rgb"):
        payload[k] = rng.uniform(size=getattr(tr, k).shape) \
            .astype(np.float32)
    bridge.load_trainer_state(tr, payload)
    out = bridge.export_trainer_state(tr)
    assert out["global_step"] == 7
    _assert_trees_equal(out["model"], payload["model"])
    _assert_trees_equal(out["ema"], payload["ema"])
    for k in ("error_map", "error_map_rgb", "occ_grid_lidar",
              "occ_grid_rgb"):
        np.testing.assert_array_equal(out[k], payload[k])


def test_unet_trees_round_trip_bit_exactly():
    """The refiner's params and BN statistics (``nvsf_tpu/models/unet.py``
    trees) load into the port's ``UNet`` and export unchanged."""
    from nvsf_tpu.models.unet import UNetSpec
    from nvsf_torch.models.unet import UNet
    params, stats = jax.tree.map(np.asarray, UNetSpec().init(
        jax.random.PRNGKey(3)))
    rng = np.random.default_rng(1)
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape)
                         .astype(np.float32), stats)
    unet = UNet()
    bridge.load_unet(unet, params, stats)
    got_p, got_s = bridge.unet_to_trees(unet)
    _assert_trees_equal(got_p, params)
    _assert_trees_equal(got_s, stats)


def _imported_modules(path):
    """Every module name an ``import`` statement of the file names."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield from (node.module + "." + a.name for a in node.names)


def test_port_imports_no_jax():
    """Every module of nvsf_torch, and chip_smoke, imports with jax, optax,
    cv2 and imageio made unimportable (the card's machine has none of
    them), and none of them names a module of nvsf_tpu (the port keeps
    its own copies of what it needs)."""
    allowed = ()
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f)
        for d, _, fs in os.walk(os.path.join(REPO, "nvsf_torch"))
        for f in fs if f.endswith(".py")]
    named = [(f, m) for f in files for m in _imported_modules(f)
             if m.split(".")[0] == "nvsf_tpu" and not m.startswith(allowed)]
    assert not named, named
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'optax', 'cv2', 'imageio'):\n"
        "    sys.modules[m] = None\n"
        "import nvsf_torch\n"
        "for info in pkgutil.walk_packages(nvsf_torch.__path__, "
        "'nvsf_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "import nvsf_torch.train.trainer, chip_smoke\n"
        "import nvsf_torch.scripts.main_nvsf, nvsf_torch.models.unet\n"
        "import nvsf_torch.scripts.quality_run\n"
        "import nvsf_torch.train.refine, nvsf_torch.train.checkpoint\n"
        "import nvsf_torch.train.test_mode, nvsf_torch.render.export\n"
        "import nvsf_torch.data.kitti360, nvsf_torch.lib.lpips\n"
        "import nvsf_torch.preprocess.kitti360, nvsf_torch.native.binding\n"
        "import nvsf_torch.scripts.preprocess_data, nvsf_torch.lib.image\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'cv2', 'imageio', 'nvsf_tpu') and "
        "sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
