"""The streaming marcher's slab loop in the form its frame graphs capture
(``Renderer._stream_composite`` / ``_slab_steps``), against the JAX
package's ``lax.while_loop`` (``nvsf_tpu/render/renderer.py:555-635``), on
the bridged field of ``test_torch_models``, and the frame graphs' cache
per renderer. The graphs themselves need the card
(``tests/test_torch_cuda.py``); here the loop runs eagerly, in the three
forms the port has for it:
  - "host": the CPU's, which reads the predicate before each slab and skips
    the slab where it is false;
  - "gated": the card's outside a capture (the eager render and the
    graphs' warm-up), every slab with its carry's writes gated on the
    predicate;
  - "if": what a replay of the IF nodes does, emulated: a slab runs where
    the predicate holds, and where it fails the slab is issued gated off,
    which must leave the carry bit for bit as it was.
Outputs are held to JAX's at FWD (rtol 1e-4, atol 1e-5: f32 sums in
another order); the three forms to each other bit for bit.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsf_tpu.ops.occupancy import OccupancyGridSpec
from nvsf_tpu.render.renderer import RendererSpec
from nvsf_torch.ops.occupancy import OccupancyGrid
from nvsf_torch.render import renderer as renderer_mod
from nvsf_torch.render.renderer import Renderer

from test_torch_models import FWD, fields, one_torch_thread  # noqa: F401

N, T, G = 48, 64, 16
S_ = 1 / 81
SETTINGS = dict(bound=1.0, min_near=1.0 * S_, min_near_lidar=1.0 * S_,
                lidar_max_depth=80.0 * S_, active_sensor=True, num_steps=T,
                max_ray_batch=16, stream_slab=8)
TRANS_EPS = 1e-4

# (grid fill, density scale, K, slab): a chunk of sky rays (no occupied
# sample: no slab), one whose rays die by transmittance in the first slabs,
# one that runs every slab, and K % S != 0 (the padded tail)
CASES = {"sky": (0.0, 300.0, 32, 8), "dies early": (32.0, 300.0, 32, 8),
         "all slabs": (32.0, 1e-3, 32, 8), "K % S": (32.0, 1e-3, 20, 8)}


def _rays(seed=16, n=N):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.05, 0.05, (n, 3)).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


def _pair(fields, density_scale, **over):  # noqa: F811
    jspec, params, field = fields
    kw = dict(SETTINGS, density_scale=density_scale, **over)
    return RendererSpec(field=jspec, **kw), params, Renderer(field=field,
                                                             **kw)


def _compacted(jrend, ro, rd, grid, K, lidar):
    """JAX's compaction of the rays' T candidates on ``grid``: z_vals,
    valid [N, K] and sample_dist [N, 1], as numpy."""
    T = jrend.num_steps
    if lidar:
        nears = np.full((len(ro), 1), jrend.min_near_lidar, np.float32)
        fars = np.full((len(ro), 1), jrend.lidar_max_depth, np.float32)
    else:
        from nvsf_tpu.render.renderer import near_far_from_aabb
        nr, fr = near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd),
                                    jrend.aabb, jrend.min_near)
        nears, fars = np.asarray(nr)[:, None], np.asarray(fr)[:, None]
    z = nears + (fars - nears) * np.asarray(
        jnp.linspace(0.0, 1.0, T, dtype=jnp.float32))[None]
    zs, valid = OccupancyGridSpec(grid_size=grid.shape[0]).compact_samples(
        jnp.asarray(grid), jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z),
        K, 1.0)
    return (np.asarray(zs), np.asarray(valid),
            ((fars - nears) / T).astype(np.float32))


def _jax_alphas(jrend, params, ro, rd, t, z, valid, sd, lidar, S):
    """JAX's quadrature of one batch, as its slab loop sees it
    (renderer.py:566-611): the alphas [N, K'] of the samples padded to a
    slab multiple K', from JAX's field, and JAX's own m [N]."""
    n, K = z.shape
    T = jrend.num_steps
    deltas = np.concatenate([z[:, 1:] - z[:, :-1], sd], -1)
    deltas = np.clip(deltas, 0.0, np.asarray(
        jrend._occ_delta_cap(jnp.asarray(sd), T, K)))
    if K % S:
        padk = S - K % S
        z = np.pad(z, ((0, 0), (0, padk)), mode="edge")
        deltas = np.pad(deltas, ((0, 0), (0, padk)))
        valid = np.pad(valid, ((0, 0), (0, padk)))
        K += padk
    xyz = np.clip(ro[:, None] + rd[:, None] * z[..., None], -1.0, 1.0)
    sigma = np.asarray(jrend.field.density(
        params, jnp.asarray(xyz.reshape(-1, 3)), t, cal_lidar_color=lidar,
        compute_dtype=jnp.float32)["sigma"]).reshape(n, K)
    sigma = np.where(valid, sigma, 0.0)
    return 1.0 - np.exp(-2.0 * deltas * jrend.density_scale * sigma), \
        valid.sum(-1)


def _while_slabs(alphas, m, S):
    """The slabs JAX's while_loop runs on one chunk: ``slab_cond``
    (renderer.py:624-627) replayed in numpy on the chunk's m and its
    transmittance after each slab."""
    K = alphas.shape[1]
    trans, i = np.ones(len(m), np.float32), 0
    while i < K // S and ((trans > TRANS_EPS) & (m > i * S)).any():
        trans = trans * np.prod(1.0 - alphas[:, i * S:(i + 1) * S] + 1e-15,
                                axis=-1)
        i += 1
    return i


def jax_frame_slabs(jrend, params, ro, rd, t, grid, K, lidar, S, C,
                    compact_chunk):
    """The slabs JAX's while_loop runs over a sorted-chunk frame
    (``_render_staged_occ``): the rays padded to whole compaction chunks
    (origin 0, direction 1, no valid sample), stably sorted by m, padded
    again to whole chunks of ``C`` rays (m 0), ``_while_slabs`` on each."""
    z, valid, sd = _compacted(jrend, ro, rd, grid, K, lidar)
    Np = -(-len(ro) // compact_chunk) * compact_chunk
    pad = Np - len(ro)
    padded = [np.concatenate([a, np.full((pad,) + a.shape[1:], f, a.dtype)])
              for a, f in ((ro, 0), (rd, 1), (z, 0), (valid, False),
                           (sd, 1))]
    order = np.argsort(padded[3].sum(-1), kind="stable")
    alphas, m = _jax_alphas(jrend, params, *(a[order] for a in padded[:2]),
                            t, *(a[order] for a in padded[2:]), lidar, S)
    tail = -(-Np // C) * C - Np
    alphas, m = np.pad(alphas, ((0, tail), (0, 0))), np.pad(m, (0, tail))
    return sum(_while_slabs(alphas[c:c + C], m[c:c + C], S)
               for c in range(0, Np + tail, C))


def _loop_form(form):
    """A ``Renderer._slab_steps`` that runs the loop in ``form``."""
    def steps(self, n, alive, body):
        for i in range(n):
            pred = alive(i)
            if form == "gated":
                body(i, pred)
            elif bool(pred):
                body(i, None)
            else:
                body(i, torch.tensor(False))
    return steps


def _stream(trend, ro, rd, t, z, valid, sd, lidar, S):
    trend.slab_counter(torch.device("cpu")).zero_()
    out = trend._stream_composite(
        torch.from_numpy(ro), torch.from_numpy(rd), torch.tensor(t),
        torch.from_numpy(z), torch.from_numpy(valid), torch.from_numpy(sd),
        cal_lidar_color=lidar, slab=S, trans_eps=TRANS_EPS)
    return out, int(trend.slabs_run)


# ----------------------------------------------------------------------
# (a) the slab loop against JAX's while_loop, four exits; (b) the slabs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("lidar", [True, False], ids=["lidar", "camera"])
def test_slab_loop_matches_jax(fields, lidar, case,  # noqa: F811
                                 monkeypatch):
    """One batch through ``_stream_composite`` in each of the three forms
    against JAX's ``_stream_composite`` on the same compacted samples; the
    slabs run (``slabs_run``) against those of JAX's loop."""
    fill, dscale, K, S = CASES[case]
    jrend, params, trend = _pair(fields, dscale)
    ro, rd = _rays()
    t = np.float32(1 / 3)
    grid = np.full((G, G, G), fill, np.float32)
    z, valid, sd = _compacted(jrend, ro, rd, grid, K, lidar)
    jo = jrend._stream_composite(
        params, jnp.asarray(ro), jnp.asarray(rd), t, jnp.asarray(z),
        jnp.asarray(valid), jnp.asarray(sd), cal_lidar_color=lidar, slab=S,
        trans_eps=TRANS_EPS)
    host, slabs = _stream(trend, ro, rd, t, z, valid, sd, lidar, S)
    for got, ref, name in zip(host, jo, ("depth", "image", "wsum")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   err_msg=name, **FWD)
    want = {"sky": 0, "all slabs": K // S, "K % S": -(-K // S)}.get(case)
    jax_slabs = _while_slabs(*_jax_alphas(jrend, params, ro, rd, t, z, valid,
                                          sd, lidar, S), S)
    assert slabs == jax_slabs, (slabs, jax_slabs)
    if want is not None:
        assert slabs == want, (slabs, want)
    else:
        assert 0 < slabs < K // S, slabs        # exited by transmittance
    assert trend.slab_checks == -(-K // S)      # one host read a step
    for form in ("gated", "if"):
        monkeypatch.setattr(Renderer, "_slab_steps", _loop_form(form))
        got, n = _stream(trend, ro, rd, t, z, valid, sd, lidar, S)
        assert n == slabs, (form, n, slabs)
        for a, b in zip(got, host):
            assert torch.equal(a, b), form


@pytest.mark.parametrize("lidar", [True, False], ids=["lidar", "camera"])
def test_staged_frame_matches_jax(fields, lidar, monkeypatch):  # noqa: F811
    """The sorted-chunk frame (``_render_staged_occ``: compaction in chunks,
    the stable sort by m, chunks of 16 rays, K 20 on slabs of 8) on a grid
    with an empty half and a dense field, so that its chunks take each
    exit: sky chunks at once, surface chunks by transmittance. Against
    JAX's ``_render_staged_occ``; the slabs against JAX's loop over the
    same sorted chunks; the gated form bit for bit."""
    K, S = 20, 8
    jrend, params, trend = _pair(fields, 300.0)
    ro, rd = _rays(7, 80)
    t = np.float32(0.6)
    grid = np.zeros((G, G, G), np.float32)
    grid[:, :, :G // 2] = 32.0
    jo = jrend._render_staged_occ(
        params, jnp.asarray(ro), jnp.asarray(rd), t,
        OccupancyGridSpec(grid_size=G), jnp.asarray(grid), K, 1.0, lidar,
        None, slab=S, compact_chunk=32)
    monkeypatch.setattr(renderer_mod, "COMPACT_CHUNK", 32)

    def staged():
        trend.slab_counter(torch.device("cpu")).zero_()
        out = trend._render_staged_occ(
            torch.from_numpy(ro), torch.from_numpy(rd), torch.tensor(t),
            OccupancyGrid(grid_size=G), torch.from_numpy(grid), K, 1.0,
            lidar, None)
        return out, int(trend.slabs_run)

    out, slabs = staged()
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jo[k]),
                                   err_msg=k, **FWD)
    # JAX's loop on each sorted chunk of 16 (pads: m 0, sample_dist 1)
    expect = jax_frame_slabs(jrend, params, ro, rd, t, grid, K, lidar, S, 16,
                             32)
    n_chunks = -(-len(ro) // 32) * 32 // 16
    assert slabs == expect, (slabs, expect)
    assert 0 < slabs < n_chunks * -(-K // S), slabs
    monkeypatch.setattr(Renderer, "_slab_steps", _loop_form("gated"))
    gated, n = staged()
    assert n == slabs
    for k in out:
        assert torch.equal(gated[k], out[k]), k


# ----------------------------------------------------------------------
# (c) run_occupancy_stream's slab argument, JAX's default 32
# ----------------------------------------------------------------------

def test_stream_slab_defaults_to_jax(fields):  # noqa: F811
    """``slab`` defaults to 32 in both packages (renderer.py:502-505), not
    to the renderer's ``stream_slab``: K 64 runs 2 slabs of 32."""
    def default(fn):
        return inspect.signature(fn).parameters["slab"].default
    assert default(Renderer.run_occupancy_stream) == 32
    assert default(RendererSpec.run_occupancy_stream) == 32
    K = 64
    jrend, params, trend = _pair(fields, 1e-3)
    ro, rd = _rays(3)
    t = np.float32(0.25)
    grid = np.full((G, G, G), 32.0, np.float32)
    jo = jrend.run_occupancy_stream(
        params, jnp.asarray(ro), jnp.asarray(rd), t,
        OccupancyGridSpec(grid_size=G), jnp.asarray(grid), num_steps_occ=K,
        cal_lidar_color=True, occ_thresh=1.0)
    trend.slab_counter(torch.device("cpu")).zero_()
    to = trend.run_occupancy_stream(
        torch.from_numpy(ro), torch.from_numpy(rd), torch.tensor(t),
        OccupancyGrid(grid_size=G), torch.from_numpy(grid), num_steps_occ=K,
        cal_lidar_color=True, occ_thresh=1.0)
    assert set(to) == set(jo)
    for k in to:
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   err_msg=k, **FWD)
    assert int(trend.slabs_run) == 2 and trend.slab_checks == 2


# ----------------------------------------------------------------------
# launches that the device decides: counted on the device, read on the host
# ----------------------------------------------------------------------

def test_device_launch_counts_fold_into_launches():
    """A launch counter on the device (``kernels.device_launch_counter``,
    which a frame graph's IF bodies add their launches to where they run;
    here on the CPU) is read into ``LAUNCHES`` by ``launch_counts`` once,
    beside the launches counted on the host, and zeroed;
    ``reset_launch_counts`` zeroes both."""
    from nvsf_torch.ops import kernels
    saved = dict(kernels.LAUNCHES)
    try:
        kernels.reset_launch_counts()
        counter = kernels.device_launch_counter(torch.device("cpu"))
        assert counter.shape == (len(kernels.LAUNCHES),)
        j = list(kernels.LAUNCHES).index("multihot_fwd")
        counter[j].add_(3)
        kernels.LAUNCHES["graph_if"] += 2
        got = kernels.launch_counts()
        assert got["multihot_fwd"] == 3 and got["graph_if"] == 2, got
        assert sum(got.values()) == 5 and int(counter.abs().sum()) == 0
        assert kernels.launch_counts() == got           # read once
        counter[j].add_(1)
        kernels.reset_launch_counts()
        assert int(counter.abs().sum()) == 0
        assert not any(kernels.launch_counts().values())
    finally:
        kernels.LAUNCHES.update(saved)


# ----------------------------------------------------------------------
# (d) each renderer has its own frame graphs
# ----------------------------------------------------------------------

def test_ema_renderer_has_its_own_frame_graphs():
    """The trainer makes its EMA renderer with ``dataclasses.replace`` of
    the live one. The frame graphs and the slab counter are not init
    fields, so the copy starts without the live renderer's graphs (which
    read the live field) even when these exist; ``drop_step_graphs`` drops
    both renderers'. A CPU render makes no graphs."""
    from nvsf_torch.config import NVSFConfig
    from nvsf_torch.data.synthetic import (SyntheticSceneSpec,
                                           make_synthetic_scene)
    from nvsf_torch.train.trainer import Trainer

    spec = SyntheticSceneSpec(num_frames=2, H_lidar=8, W_lidar=16, H=8,
                              W=8, max_depth=80.0, scale=S_)
    cfg = NVSFConfig.from_dict(dict(
        enable_lidar=True, enable_rgb=False, num_frames=2, scale=S_,
        bound=1.0, min_near_lidar=S_, lidar_max_depth=80 * S_,
        active_sensor=True, num_steps=16, num_steps_occ=8,
        render_mode="occupancy", log2_hashmap_size=14, n_levels_hash=4,
        n_features_per_level_hash=8, flow_n_levels=4, occ_grid_size=8))
    tr = Trainer(cfg, make_synthetic_scene(spec), device="cpu")
    live, ema = tr.renderer, tr.ema_renderer
    assert ema.field is tr.ema_field and live.field is tr.field
    out = tr.render_lidar_frame(0)
    assert np.isfinite(out["depth"]).all()
    assert live._frame_graphs is None and ema._frame_graphs is None
    assert int(live.slabs_run) > 0 and ema.slabs_run is None
    assert live.frame_graphs is not ema.frame_graphs
    assert live.frame_graphs.renderer is live
    assert ema.frame_graphs.renderer is ema
    live.frame_graphs.graphs[("a capture",)] = "of the live field"
    copy = dataclasses.replace(live, field=tr.ema_field)
    assert copy._frame_graphs is None and copy.slabs_run is None
    assert copy.frame_graphs.graphs == {}
    tr.drop_step_graphs()
    assert live._frame_graphs is None and ema._frame_graphs is None
