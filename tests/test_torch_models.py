"""The port's encoders, field, renderer, rays, samplers and losses against
the JAX package on the CPU, on bridged weights and numpy inputs from a
seed (f32 throughout).

Tolerances: forward rtol 1e-4 / atol 1e-5 and gradients atol 1e-4 x
max|reference| per parameter — f32 transcendentals and summation orders
differ between XLA and PyTorch by a few ulps, and each parameter is held to
its own scale because table gradients are orders of magnitude smaller
than MLP gradients. Integer outputs (sample indices, occupancy masks) must
be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsf_tpu.data import sampler as jsampler
from nvsf_tpu.lib import rays as jrays
from nvsf_tpu.models.field import NVSFFieldSpec
from nvsf_tpu.ops.occupancy import OccupancyGridSpec
from nvsf_tpu.render.renderer import RendererSpec
from nvsf_tpu.train import losses as jlosses
from nvsf_torch import bridge
from nvsf_torch.data import sampler as tsampler
from nvsf_torch.lib import rays as trays
from nvsf_torch.models.field import FieldSpec, NVSFField
from nvsf_torch.ops.occupancy import OccupancyGrid
from nvsf_torch.render.renderer import Renderer
from nvsf_torch.train import losses as tlosses

FWD = dict(rtol=1e-4, atol=1e-5)
# level 0 (resolution 16, 17^3 <= 2^14 slots) is indexed densely, the others
# are hashed; corner 256 x prime 3674653429 is past 2^32
FIELD = dict(min_resolution=16, n_levels_plane=4,
             n_features_per_level_plane=8, base_resolution=16,
             max_resolution=256, time_resolution=8, n_levels_hash=4,
             n_features_per_level_hash=8, log2_hashmap_size=14,
             hash_size_dynamic=(12, 11, 11), flow_n_levels=4,
             flow_n_features_per_level=8, flow_base_resolution=16,
             flow_max_resolution=256, flow_log2_hashmap_size=12,
             num_frames=4, bound=1.0)


def _grad_close(got, ref, name=""):
    ref = np.asarray(ref)
    got = np.zeros_like(ref) if got is None else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=0, err_msg=name,
                               atol=1e-4 * max(np.abs(ref).max(), 1e-12))


@pytest.fixture(scope="module")
def fields():
    """A JAX field and its bridged port. The weights are perturbed from
    the init so that the time planes (initialized to ones) pass gradient
    to the warped positions, i.e. to the flow field."""
    jspec = NVSFFieldSpec(**FIELD)
    tree = jax.tree.map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.1
                   * max(float(np.abs(a).max()), 1e-3)).astype(np.float32),
        tree)
    field = NVSFField(FieldSpec(**FIELD))
    bridge.load_field(field, tree)
    return jspec, jax.tree.map(jnp.asarray, tree), field


def _compare_grads(jgrads, field, names=None):
    flat = bridge.flatten_tree(jax.tree.map(np.asarray, jgrads))
    for name, p in field.named_parameters():
        if names is None or name.split(".")[0] in names:
            _grad_close(None if p.grad is None else p.grad.numpy(),
                        flat[name], name)


def _points(seed, n, lo=-0.9, hi=0.9):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)) \
        .astype(np.float32)


def test_hash_static_matches_jax(fields):
    jspec, params, field = fields
    x = (_points(1, 2000) + 1) / 2
    hs = jspec.hash_spec
    enc = field.hash_lidar.static_grid
    cols, _ = enc.level_cols_weights(torch.from_numpy(x))
    jcols, _ = hs.static_grid.level_cols_weights(jnp.asarray(x))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
    ct = np.random.default_rng(2).standard_normal((2000, 32)) \
        .astype(np.float32)
    jv, jg = jax.value_and_grad(lambda p: jnp.sum(
        hs.apply_static(p, jnp.asarray(x)) * ct))(params["hash_lidar"])
    field.zero_grad(set_to_none=True)
    out = field.hash_lidar.apply_static(torch.from_numpy(x))
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(hs.apply_static(
            params["hash_lidar"], jnp.asarray(x))), **FWD)
    (out * torch.from_numpy(ct)).sum().backward()
    _grad_close(field.hash_lidar.static.grad.numpy(), jg["static"])


def test_hash_dynamic_fused3_matches_jax(fields):
    """The t-query carries table gradient, the two warp queries none."""
    jspec, params, field = fields
    x = (_points(3, 1500) + 1) / 2
    x1 = x + _points(4, 1500, -0.05, 0.05)
    x2 = x + _points(5, 1500, -0.05, 0.05)
    t, t1, t2 = 0.4, 0.5, 0.0
    rng = np.random.default_rng(6)
    cts = [rng.standard_normal((1500, 24)).astype(np.float32)
           for _ in range(3)]
    hs = jspec.hash_spec

    def jf(p):
        outs = hs.apply_dynamic_fused3(p, *map(jnp.asarray, (x, x1, x2)),
                                       t, t1, t2)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cts)), outs

    (jv, jouts), jg = jax.value_and_grad(jf, has_aux=True)(
        params["hash_lidar"])
    field.zero_grad(set_to_none=True)
    outs = field.hash_lidar.apply_dynamic_fused3(
        *map(torch.from_numpy, (x, x1, x2)),
        *map(torch.tensor, (t, t1, t2)))
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **FWD)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cts)) \
        .backward()
    for k in ("dyn_xyt", "dyn_xzt", "dyn_yzt"):
        _grad_close(getattr(field.hash_lidar, k).grad.numpy(), jg[k], k)


def test_planes_match_jax(fields):
    """Static planes (coarse scales through multihot without weight
    gradient, fine scales through gathers) and the three-query dynamic
    planes, with gradients to the tables and to the query positions."""
    jspec, params, field = fields
    ps = jspec.planes_spec
    rng = np.random.default_rng(7)
    xt = np.concatenate([(_points(8, 1000) + 1) / 2,
                         np.full((1000, 1), 0.3, np.float32)], -1)
    xts = np.stack([xt, xt, xt])
    xts[1:, :, :3] += rng.uniform(-0.05, 0.05, (2, 1000, 3))
    xts[1, :, 3], xts[2, :, 3] = 0.5, 0.0
    xts = xts.astype(np.float32)
    cs = rng.standard_normal((1000, 32)).astype(np.float32)
    cd = rng.standard_normal((3, 1000, 32)).astype(np.float32)

    def jf(p, q):
        s = ps.apply_static(p, jnp.asarray(xt))
        d = ps.apply_dynamic_multi(p, q)
        return jnp.sum(s * cs) + jnp.sum(d * cd), (s, d)

    (_, (js, jd)), (jgp, jgq) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(params["planes_lidar"],
                                          jnp.asarray(xts))
    field.zero_grad(set_to_none=True)
    q = torch.from_numpy(xts).requires_grad_(True)
    s = field.planes_lidar.apply_static(torch.from_numpy(xt))
    d = field.planes_lidar.apply_dynamic_multi(q)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), **FWD)
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd), **FWD)
    ((s * torch.from_numpy(cs)).sum() + (d * torch.from_numpy(cd)).sum()) \
        .backward()
    _compare_grads({"planes_lidar": jgp}, field, ("planes_lidar",))
    # spatial coordinates only: the time coordinate never carries gradient
    # in the field, and at t = 0 JAX's clip splits its gradient in half
    _grad_close(q.grad.numpy()[..., :3], np.asarray(jgq)[..., :3],
                "query positions")


@pytest.mark.parametrize("skip_warp", [False, True],
                         ids=["warp", "skip_warp"])
def test_field_density_matches_jax(fields, skip_warp):
    jspec, params, field = fields
    x = _points(9, 3000)
    rng = np.random.default_rng(10)
    c1 = rng.standard_normal(3000).astype(np.float32)
    c2 = rng.standard_normal((3000, 15)).astype(np.float32)
    t = np.float32(2 / 3)

    def jf(p):
        o = jspec.density(p, jnp.asarray(x), t, cal_lidar_color=True,
                          skip_warp=skip_warp)
        return jnp.sum(o["sigma"] * c1) + jnp.sum(o["geo_feat"] * c2), o

    (_, jo), jg = jax.value_and_grad(jf, has_aux=True)(params)
    field.zero_grad(set_to_none=True)
    o = field.density(torch.from_numpy(x), torch.tensor(t),
                      cal_lidar_color=True, skip_warp=skip_warp)
    for k in ("sigma", "geo_feat"):
        np.testing.assert_allclose(o[k].detach().numpy(), np.asarray(jo[k]),
                                   **FWD)
    ((o["sigma"] * torch.from_numpy(c1)).sum()
     + (o["geo_feat"] * torch.from_numpy(c2)).sum()).backward()
    _compare_grads(jg, field)
    if not skip_warp:   # the flow field learns through the warped planes
        assert field.flow.grid.grad.abs().max() > 0


@pytest.mark.parametrize("lidar", [True, False], ids=["lidar", "camera"])
def test_field_color_and_flow_match_jax(fields, lidar):
    jspec, params, field = fields
    rng = np.random.default_rng(11)
    x = _points(12, 500)
    d = rng.standard_normal((500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    geo = rng.standard_normal((500, 15)).astype(np.float32)
    mask = rng.uniform(size=500) < 0.7
    nout = 2 if lidar else 3
    c = rng.standard_normal((500, nout)).astype(np.float32)
    cf = rng.standard_normal((500, 6)).astype(np.float32)

    def jf(p):
        h = jspec.color(p, jnp.asarray(x), jnp.asarray(d), jnp.asarray(geo),
                        cal_lidar_color=lidar, mask=jnp.asarray(mask))
        f = jspec.flow(p, jnp.asarray(x), 0.25)
        fl = jnp.concatenate([f["flow_forward"], f["flow_backward"]], -1)
        return jnp.sum(h * c) + jnp.sum(fl * cf), (h, fl)

    (_, (jh, jfl)), jg = jax.value_and_grad(jf, has_aux=True)(params)
    field.zero_grad(set_to_none=True)
    h = field.color(torch.from_numpy(x), torch.from_numpy(d),
                    torch.from_numpy(geo), cal_lidar_color=lidar,
                    mask=torch.from_numpy(mask))
    f = field.flow_at(torch.from_numpy(x), 0.25)
    fl = torch.cat([f["flow_forward"], f["flow_backward"]], -1)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **FWD)
    np.testing.assert_allclose(fl.detach().numpy(), np.asarray(jfl), **FWD)
    ((h * torch.from_numpy(c)).sum()
     + (fl * torch.from_numpy(cf)).sum()).backward()
    _compare_grads(jg, field, ("flow", "raydrop_net", "intensity_net",
                               "color_net"))


@pytest.mark.parametrize("lidar", [True, False], ids=["lidar", "camera"])
def test_run_occupancy_matches_jax(fields, lidar):
    """Occupancy-compacted rendering with the JAX z-noise and jitter draws
    injected, outputs and parameter gradients."""
    jspec, params, field = fields
    N, T, K, G = 128, 64, 24, 32
    s = 1 / 81
    kw = dict(bound=1.0, min_near=1.0 * s, min_near_lidar=1.0 * s,
              lidar_max_depth=80.0 * s, active_sensor=True, num_steps=T)
    jrend = RendererSpec(field=jspec, **kw)
    trend = Renderer(field=field, **kw)
    rng = np.random.default_rng(13)
    ro = np.tile(np.array([[0.02, -0.01, 0.02]], np.float32), (N, 1))
    rd = rng.standard_normal((N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    grid = np.full((G, G, G), 32.0, np.float32)
    grid[:, :, :G // 2 - 2] = 0.0
    key = jax.random.PRNGKey(14)
    k, kz = jax.random.split(key)
    _, kj = jax.random.split(k)
    draws = dict(z_noise=torch.from_numpy(np.asarray(
        jax.random.uniform(kz, (N, T)))), jitter_u=torch.from_numpy(
        np.asarray(jax.random.uniform(kj, (N, K)))))
    t = np.float32(1 / 3)
    cd = rng.standard_normal(N).astype(np.float32)
    ci = rng.standard_normal((N, 2 if lidar else 3)).astype(np.float32)
    dk, ik = ("depth_lidar", "image_lidar") if lidar else ("depth", "image")

    def jf(p):
        o = jrend.run_occupancy(p, jnp.asarray(ro), jnp.asarray(rd), t,
                                OccupancyGridSpec(grid_size=G),
                                jnp.asarray(grid), num_steps_occ=K,
                                cal_lidar_color=lidar, perturb=True, key=key,
                                occ_thresh=1.0)
        return jnp.sum(o[dk] * cd) + jnp.sum(o[ik] * ci), o

    (_, jo), jg = jax.value_and_grad(jf, has_aux=True)(params)
    field.zero_grad(set_to_none=True)
    o = trend.run_occupancy(torch.from_numpy(ro), torch.from_numpy(rd),
                            torch.tensor(t), OccupancyGrid(grid_size=G),
                            torch.from_numpy(grid), num_steps_occ=K,
                            cal_lidar_color=lidar, perturb=True,
                            occ_thresh=1.0, **draws)
    np.testing.assert_array_equal(o["z_vals"].detach().numpy(),
                                  np.asarray(jo["z_vals"]))
    for k_ in o:
        np.testing.assert_allclose(o[k_].detach().numpy(),
                                   np.asarray(jo[k_]), err_msg=k_, **FWD)
    ((o[dk] * torch.from_numpy(cd)).sum()
     + (o[ik] * torch.from_numpy(ci)).sum()).backward()
    _compare_grads(jg, field)


def test_rays_match_jax():
    rng = np.random.default_rng(15)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    pose[:3, 3] = rng.uniform(-0.2, 0.2, 3)
    inds = rng.integers(0, 24 * 64, 500).astype(np.int32)
    jo, jd = jrays.get_lidar_rays(jnp.asarray(pose), jnp.asarray(inds), 24,
                                  64, (10.0, 40.0), (180.0, 360.0))
    to, td = trays.get_lidar_rays(torch.from_numpy(pose),
                                  torch.from_numpy(inds), 24, 64,
                                  (10.0, 40.0), (180.0, 360.0))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **FWD)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD)
    K = np.array([[32.0, 0, 20], [0, 32.0, 16], [0, 0, 1]], np.float32)
    jo, jd = jrays.get_camera_rays(jnp.asarray(pose), jnp.asarray(inds), 32,
                                   40, jnp.asarray(K))
    to, td = trays.get_camera_rays(torch.from_numpy(pose),
                                   torch.from_numpy(inds), 32, 40,
                                   torch.from_numpy(K))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **FWD)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD)


def _jax_sampler_draws(key, mode, n, em_size):
    t = lambda a: torch.from_numpy(np.asarray(a))
    if mode == "random":
        return {"inds": t(jax.random.randint(key, (n,), 0, 24 * 64,
                                             jnp.int32))}
    if mode == "patch":
        kx, ky = jax.random.split(key)
        return {"x": t(jax.random.randint(kx, (n,), 0, 64 - 8, jnp.int32)),
                "y": t(jax.random.randint(ky, (n,), 0, 24 - 2, jnp.int32))}
    k_sel, k_jx, k_jy = jax.random.split(key, 3)
    d = {"ux": t(jax.random.uniform(k_jx, (n,))),
         "uy": t(jax.random.uniform(k_jy, (n,)))}
    d["gumbel"] = t(jax.random.gumbel(k_sel, (em_size,)))
    return d


@pytest.mark.parametrize("mode", ["random", "error_map", "patch",
                                  "patch_error_map"])
def test_sampler_matches_jax(mode):
    rng = np.random.default_rng(16)
    em = rng.uniform(1, 100, (12, 32)).astype(np.float32)
    key = jax.random.PRNGKey(17)
    patch = (2, 8) if mode.startswith("patch") else 1
    use_em = mode.endswith("error_map")
    N = 128
    ref = jsampler.sample_indices(key, 24, 64, N, patch_size=patch,
                                  error_map=jnp.asarray(em),
                                  use_error_map=use_em)
    n_draw = N // 16 if mode.startswith("patch") else N
    draws = _jax_sampler_draws(key, "patch" if mode == "patch" else
                               "random" if mode == "random" else "em",
                               n_draw, em.size)
    got = tsampler.sample_indices(24, 64, N, patch_size=patch,
                                  error_map=torch.from_numpy(em),
                                  use_error_map=use_em, draws=draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_error_map_categorical_fallback_matches_jax():
    """More rays than coarse cells: sampling with replacement."""
    em = np.random.default_rng(18).uniform(1, 10, (4, 5)).astype(np.float32)
    key = jax.random.PRNGKey(19)
    ref = jsampler.sample_error_map_indices(key, jnp.asarray(em), 16, 20, 64)
    k_sel, k_jx, k_jy = jax.random.split(key, 3)
    logw = jnp.log(jnp.maximum(jnp.asarray(em).reshape(-1), 1e-12))
    t = lambda a: torch.from_numpy(np.asarray(a))
    draws = {"coarse": t(jax.random.categorical(k_sel, logw, shape=(64,))),
             "ux": t(jax.random.uniform(k_jx, (64,))),
             "uy": t(jax.random.uniform(k_jy, (64,)))}
    got = tsampler.sample_error_map_indices(torch.from_numpy(em), 16, 20, 64,
                                            draws=draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_update_error_map_matches_jax():
    """Unique coarse cells: duplicate writes land in an unspecified order
    in both frameworks."""
    rng = np.random.default_rng(20)
    em = rng.uniform(1, 100, (12, 32)).astype(np.float32)
    cells = rng.permutation(12 * 32)[:200]
    inds = ((cells // 32) * 2 * 64 + (cells % 32) * 2).astype(np.int32)
    err = rng.uniform(0, 3, 200).astype(np.float32)
    ref = jsampler.update_error_map(jnp.asarray(em), jnp.asarray(inds),
                                    jnp.asarray(err), 24, 64)
    got = tsampler.update_error_map(torch.from_numpy(em),
                                    torch.from_numpy(inds),
                                    torch.from_numpy(err), 24, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)


def test_losses_match_jax():
    rng = np.random.default_rng(21)
    n, k = 64, 16
    a = {k_: rng.uniform(0, 1, n).astype(np.float32)
         for k_ in ("prd", "pi", "pd", "gi", "gd")}
    gr = (rng.uniform(size=n) < 0.7).astype(np.float32)
    j = lambda v: jnp.asarray(v)
    t = torch.from_numpy
    for names in (("mse", "l1", "mse"), ("bce", "huber", "smoothl1")):
        jc = {k_: jlosses.make_criterion(nm, 0.05) for k_, nm in
              zip(("raydrop", "depth", "intensity"), names)}
        tc = {k_: tlosses.make_criterion(nm, 0.05) for k_, nm in
              zip(("raydrop", "depth", "intensity"), names)}
        jt, jp = jlosses.lidar_losses(j(a["prd"]), j(a["pi"]), j(a["pd"]),
                                      j(gr), j(a["gi"]), j(a["gd"]), jc,
                                      smooth_factor=0.1)
        tt, tp = tlosses.lidar_losses(t(a["prd"]), t(a["pi"]), t(a["pd"]),
                                      t(gr), t(a["gi"]), t(a["gd"]), tc,
                                      smooth_factor=0.1)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **FWD)
        for k_ in jp:
            np.testing.assert_allclose(float(tp[k_]), float(jp[k_]), **FWD)
    w = rng.uniform(0, 0.2, (n, k)).astype(np.float32)
    z = np.sort(rng.uniform(0, 1, (n, k)), -1).astype(np.float32)
    gd = a["gd"] * gr
    np.testing.assert_allclose(
        float(tlosses.urf_line_of_sight_loss(t(w), t(z), t(gd), 30, 100)),
        float(jlosses.urf_line_of_sight_loss(j(w), j(z), j(gd), 30, 100)),
        **FWD)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(tlosses.lidar_chamfer_loss(t(rd), t(a["pd"]), t(gd), 0.05)),
        float(jlosses.lidar_chamfer_loss(j(rd), j(a["pd"]), j(gd), 0.05)),
        **FWD)
    pc, pn = (rng.standard_normal((80, 3)).astype(np.float32)
              for _ in range(2))
    pm, pnm = (rng.uniform(size=80) < 0.8 for _ in range(2))
    fl = rng.standard_normal((80, 3)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        float(tlosses.flow_consistency_loss(t(pc), t(pm), t(pn), t(pnm),
                                            t(fl))),
        float(jlosses.flow_consistency_loss(j(pc), j(pm), j(pn), j(pnm),
                                            j(fl))), **FWD)
    bad = np.array([1.0, np.nan, np.inf], np.float32)
    np.testing.assert_array_equal(tlosses.scrub_loss(t(bad)).numpy(),
                                  np.asarray(jlosses.scrub_loss(j(bad))))
