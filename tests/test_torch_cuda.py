"""The port's CUDA kernels against their plain PyTorch versions, and one
training step through them. These need an NVIDIA GPU with nvcc and skip
without one; on the card run them without the JAX test setup:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: a kernel's f32 sums run in another order than the plain
version's (atomics land in any order), so each output is held to 1e-5 of
the sum of the magnitudes of its terms.
"""

import numpy as np
import pytest
import torch

from nvsf_torch.ops import kernels
from nvsf_torch.ops import multihot as mh
from nvsf_torch.ops import segsum

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, bound):
    err = float((got - ref).abs().max())
    assert err <= 1e-5 * float(bound.abs().max()) + 1e-7, err


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_segment_add_kernel(dev, precision):
    g = torch.Generator(device=dev).manual_seed(0)
    T, M, F = 50_000, 400_000, 8
    cols = torch.randint(0, T, (M,), generator=g, device=dev,
                         dtype=torch.int32)
    vals = torch.randn((F, M + 100), generator=g, device=dev)[:, :M]
    n0 = kernels.LAUNCHES["segment_add"]
    got = segsum.segment_add_fm(cols, vals, T, precision)
    assert kernels.LAUNCHES["segment_add"] == n0 + 1
    ref = segsum.segment_add_plain(cols, vals, T, precision)
    _close(got, ref, segsum.segment_add_plain(cols, vals.abs(), T, "f32"))


@pytest.mark.parametrize("shape", [(1, 6, 4, 4096, False),
                                   (3, 12, 2, 256, True)],
                         ids=["static-coarse", "dynamic"])
def test_multihot_kernels(dev, shape):
    Q, S, C, W, need_dw = shape
    F, Np = 8, 20_000
    g = torch.Generator(device=dev).manual_seed(1)
    tables = torch.rand((F, Q * S * W), generator=g, device=dev)
    cols = torch.randint(0, W, (Q, S, C, Np), generator=g, device=dev,
                         dtype=torch.int32)
    ws = torch.rand((Q, S, C, Np), generator=g, device=dev)
    gr = torch.randn((Q, S, F, Np), generator=g, device=dev)
    out = mh.multihot_fwd_cuda(tables, cols, ws, W)
    _close(out, mh.multihot_fwd_plain(tables, cols, ws, W),
           mh.multihot_fwd_plain(tables, cols, ws, W))
    dt, dw = mh.multihot_bwd_cuda(tables, cols, ws, gr, W, need_dw)
    rdt, rdw = mh.multihot_bwd_plain(tables, cols, ws, gr, W, need_dw)
    bdt, bdw = mh.multihot_bwd_plain(tables, cols, ws, gr.abs(), W, need_dw)
    _close(dt, rdt, bdt)
    if need_dw:
        _close(dw, rdw, bdw)
    else:
        assert dw is None


def test_training_step_launches_every_kernel(dev):
    """Two steps of the joint trainer at toy size run through B1, B3 and
    B4 and leave finite parameters."""
    from nvsf_tpu.config import NVSFConfig
    from nvsf_torch.data.synthetic import (SyntheticSceneSpec,
                                           make_synthetic_scene)
    from nvsf_torch.train.trainer import Trainer

    spec = SyntheticSceneSpec(num_frames=4, H_lidar=24, W_lidar=64, H=32,
                              W=40, max_depth=80.0, scale=1 / 81)
    s = spec.scale
    cfg = NVSFConfig.from_dict(dict(
        enable_lidar=True, enable_rgb=True, num_frames=4, scale=s, bound=1.0,
        min_near_lidar=s, lidar_max_depth=80 * s, min_near=s,
        active_sensor=True, num_rays=256, num_rays_lidar=256, num_steps=64,
        num_steps_occ=32, render_mode="occupancy", log2_hashmap_size=14,
        n_levels_hash=4, n_features_per_level_hash=8, flow_n_levels=4,
        flow_n_features_per_level=32, iters=100, fp16=True, flow_loss=True,
        use_urf_loss=True, use_error_map=True))
    tr = Trainer(cfg, make_synthetic_scene(spec), device=dev)
    kernels.reset_launch_counts()
    for patch in (False, True):
        m = tr.train_step(0, patch)
        assert np.isfinite(float(m["loss"]))
    torch.cuda.synchronize()
    assert all(v > 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    assert all(torch.isfinite(p).all() for p in tr.field.parameters())
