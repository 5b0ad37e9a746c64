"""Volume rendering (counterpart of ``nvsf_tpu/render/renderer.py``):
``near_far_from_aabb``, the dense uniform ``run`` with its chunked and
recomputed density query (``remat_chunks``) and its optional importance
resampling (``sample_pdf``), ``stratified_segment_jitter`` and
``run_occupancy`` for occupancy-mode training, ``run_joint``, which
renders a LiDAR and a camera batch with each encoder family run once for
both (``joint_fusion``), and ``render``, the JAX
package's ``render(staged=True)``: chunks of dense ``run`` without an
occupancy grid, the streaming marcher ``run_occupancy_stream`` /
``_render_staged_occ`` with one. On the card the eval renders replay
the renderer's CUDA graphs (``render/frame_graph.py``), the marcher's
slab loop as conditional IF nodes; ``render_eager`` renders without them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field as dc_field
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from nvsf_torch.lib.constants import device_constant
from nvsf_torch.models.field import NVSFField
from nvsf_torch.ops.occupancy import OccupancyGrid
from nvsf_torch.render.frame_graph import FrameGraphs, run_chunks
from nvsf_torch.train.profiler import traced

# rays compacted at once by the full-frame render (renderer.py:641)
COMPACT_CHUNK = 8192


def near_far_from_aabb(rays_o, rays_d, aabb, min_near=0.05):
    """Per-ray slab test against aabb [6] = (min xyz, max xyz) ->
    (nears [N], fars [N]); rays that miss get near == far."""
    eps = 1e-15
    safe = torch.where(rays_d.abs() < eps,
                       torch.where(rays_d >= 0, eps, -eps), rays_d)
    inv_d = 1.0 / safe
    t0 = (aabb[:3] - rays_o) * inv_d
    t1 = (aabb[3:] - rays_o) * inv_d
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    nears = torch.clamp(tmin, min=min_near)
    fars = torch.maximum(tmax, nears)
    return nears, fars


def linspace01(T: int, device=None) -> torch.Tensor:
    """linspace(0, 1, T) in f32 as XLA computes it: i * f32(1 / (T - 1)),
    the last point exactly 1 (the compaction thresholds see every ulp).
    Made once per (T, device) (``lib/constants.py``): read only."""
    return _linspace01(T, torch.device(device or "cpu"))


@functools.lru_cache(maxsize=None)
def _linspace01(T: int, device: torch.device) -> torch.Tensor:
    z = torch.arange(T, dtype=torch.float32, device=device) \
        * device_constant(1.0 / (T - 1), torch.float32, device)
    z[-1:].fill_(1.0)
    return z


def sample_pdf(bins, weights, n_samples: int, det: bool = False,
               u: Optional[torch.Tensor] = None, generator=None):
    """Inverse-CDF sampling of ``n_samples`` depths per ray
    (``renderer.py:85-109``): bins [B, T] z values, weights [B, T - 1]
    -> [B, n_samples]. ``u`` [B, n_samples] (uniform in [0, 1)) replaces
    the draws from ``generator``; ``det`` takes evenly spaced ones."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    shape = cdf.shape[:-1] + (n_samples,)
    if u is None:
        if det:
            u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples,
                               n_samples, device=cdf.device).expand(shape)
        else:
            u = torch.rand(shape, generator=generator, device=cdf.device)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(cdf.shape[-1] - 1)
    cdf_b, cdf_a = cdf.gather(-1, below), cdf.gather(-1, above)
    bin_b, bin_a = bins.gather(-1, below), bins.gather(-1, above)
    denom = torch.where(cdf_a - cdf_b < 1e-5, 1.0, cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    return bin_b + t * (bin_a - bin_b)


def stratified_segment_jitter(z_sel, sample_dist, T: int, K: int,
                              u: torch.Tensor):
    """Spread compacted samples over their local segments: each z is drawn
    as z - w_l + u * (w_l + w_r), w_l / w_r reaching to the midpoints of
    its gaps (sample_dist / 2 at the span ends), each capped at
    sample_dist * T / K. z_sel [N, K] ascending; sample_dist [N, 1];
    u [N, K] uniform in [0, 1)."""
    N = z_sel.shape[0]
    gap_r = torch.cat([z_sel[:, 1:] - z_sel[:, :-1],
                       sample_dist.expand(N, 1)], dim=-1)
    gap_l = torch.cat([sample_dist.expand(N, 1), gap_r[:, :-1]], dim=-1)
    half_cap = sample_dist * (T / K)
    w_l = torch.minimum(0.5 * gap_l, half_cap)
    w_r = torch.minimum(0.5 * gap_r, half_cap)
    return z_sel - w_l + u * (w_l + w_r)


class _Cumprod(torch.autograd.Function):
    """``torch.cumprod`` along the last axis, with the backward torch takes
    when no factor is zero, (reversed cumsum of out * grad) / x. Torch's
    own backward first asks the host whether any factor is zero, a
    synchronisation that a captured step cannot hold; the compositing's
    factors 1 - alpha + 1e-15 never are."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return (out * g).flip(-1).cumsum(-1).flip(-1).div(x)


@dataclass
class Renderer:
    """Compositing settings around a field (``RendererSpec``)."""
    field: NVSFField
    bound: float = 1.0
    density_scale: float = 1.0
    min_near: float = 0.01
    min_near_lidar: float = 0.01
    lidar_max_depth: float = 0.81
    active_sensor: bool = False
    num_steps: int = 768
    upsample_steps: int = 0        # > 0: importance resampling in ``run``
    compute_dtype: torch.dtype = torch.float32
    # > 1: the density query runs in this many sequential chunks, each
    # recomputed in the backward instead of keeping its activations
    remat_chunks: int = 1
    occ_jitter: bool = True
    occ_delta_clamp: float = 0.0
    max_ray_batch: int = 4096      # rays per render chunk at eval
    stream_slab: int = 16          # samples per early-exit slab at eval
    # host reads of "is any ray of the chunk alive" made by the streaming
    # marcher, one before each slab it may run (a device -> host sync
    # each); only the CPU reads them, the card decides on the device
    slab_checks: int = dc_field(default=0, compare=False)
    # slabs the marcher ran: an int64 counter on the field's device that
    # each slab adds one to where it runs (``slab_counter``); reset it with
    # ``zero_()``, a captured frame adds to it at its address
    slabs_run: Optional[torch.Tensor] = dc_field(
        default=None, init=False, repr=False, compare=False)
    # this renderer's captured frame renders (``frame_graphs``); not an
    # init field, so that ``dataclasses.replace`` (the EMA renderer) starts
    # without the graphs of the renderer it copies, which read that
    # renderer's field
    _frame_graphs: Optional[object] = dc_field(
        default=None, init=False, repr=False, compare=False)

    def aabb(self, device):
        b = float(self.bound)
        return device_constant((-b, -b, -b, b, b, b), torch.float32, device)

    def _occ_delta_cap(self, sample_dist, T, K):
        """clamp * sample_dist, or the legacy 2 * (T / K) * sample_dist."""
        c = self.occ_delta_clamp
        return sample_dist * (c if c > 0 else 2.0 * (T / K))

    def _near_far(self, rays_o, rays_d, cal_lidar_color):
        """[N, 1] nears and fars: the LiDAR range, or the box's slab test."""
        N, dev = rays_o.shape[0], rays_o.device
        if cal_lidar_color:
            return (torch.full((N, 1), self.min_near_lidar, device=dev),
                    torch.full((N, 1), self.lidar_max_depth, device=dev))
        nears, fars = near_far_from_aabb(rays_o, rays_d, self.aabb(dev),
                                         self.min_near)
        return nears[:, None], fars[:, None]

    def render_noise(self, n: int, K: Optional[int], generator, device,
                     given: Optional[dict] = None) -> dict:
        """A branch's perturbation draws for ``n`` rays: ``z_noise`` [n, T]
        and, with ``K`` (occupancy sampling) and ``occ_jitter``,
        ``jitter_u`` [n, K]. Each is taken from ``given`` where it is
        there, else drawn from ``generator`` in that order (a caller that
        draws at the batch's full shape and slices gets the draws a
        single render of the batch makes)."""
        dr = {k: v for k, v in (given or {}).items() if v is not None}
        if "z_noise" not in dr:
            dr["z_noise"] = torch.rand((n, self.num_steps),
                                       generator=generator, device=device)
        if K is not None and self.occ_jitter and "jitter_u" not in dr:
            dr["jitter_u"] = torch.rand((n, K), generator=generator,
                                        device=device)
        return dr

    def _query_density(self, pts, time, cal_lidar_color, skip_warp=False):
        """The field's density over a flat [M, 3] point batch
        (``renderer.py:176-200``). With ``remat_chunks`` C > 1 the batch
        goes through C sequential chunks of near-equal size, each under
        ``torch.utils.checkpoint`` while gradients are on: the backward
        recomputes a chunk's encoder internals instead of keeping them for
        all M points. The outputs are those of one query."""
        def fn(p):
            out = self.field.density(p, time, cal_lidar_color=cal_lidar_color,
                                     compute_dtype=self.compute_dtype,
                                     skip_warp=skip_warp)
            return out["sigma"], out["geo_feat"]

        C = self.remat_chunks
        if C <= 1:
            sigma, geo = fn(pts)
            return {"sigma": sigma, "geo_feat": geo}
        remat = torch.is_grad_enabled()
        outs = [checkpoint(fn, p, use_reentrant=False,
                           preserve_rng_state=False) if remat else fn(p)
                for p in pts.tensor_split(C)]
        return {"sigma": torch.cat([o[0] for o in outs]),
                "geo_feat": torch.cat([o[1] for o in outs])}

    def _composite(self, rays_d, xyzs, z_vals, deltas, dout, *,
                   cal_lidar_color, bg_color, valid=None):
        """Alpha compositing of N rays x S samples and their colors: the
        tail shared by ``run`` and ``run_occupancy``. ``valid`` [N, S]
        masks out empty compacted slots."""
        N, S = z_vals.shape
        sigmas = dout["sigma"].reshape(N, S)
        if valid is not None:
            sigmas = torch.where(valid, sigmas, 0.0)
        # LiDAR is an active sensor: light crosses the medium twice
        exponent = 2.0 if self.active_sensor else 1.0
        alphas = 1.0 - torch.exp(-exponent * deltas * self.density_scale
                                 * sigmas)
        trans = _Cumprod.apply(
            torch.cat([torch.ones((N, 1), device=z_vals.device),
                       1.0 - alphas + 1e-15], dim=-1))[:, :-1]
        weights = alphas * trans

        dirs = rays_d[:, None, :].expand(N, S, 3)
        mask = weights > 1e-4
        if valid is not None:
            mask = mask & valid
        rgbs = self.field.color(xyzs.reshape(-1, 3), dirs.reshape(-1, 3),
                                dout["geo_feat"],
                                cal_lidar_color=cal_lidar_color,
                                mask=mask.reshape(-1),
                                compute_dtype=self.compute_dtype)
        rgbs = rgbs.reshape(N, S, -1)

        weights_sum = weights.sum(dim=-1)
        depth = (weights * z_vals).sum(dim=-1)
        image = (weights[..., None] * rgbs).sum(dim=-2)
        if cal_lidar_color:
            return {"depth_lidar": depth, "image_lidar": image,
                    "weights_sum_lidar": weights_sum,
                    "weights": weights, "z_vals": z_vals}
        if bg_color is None:
            bg_color = 1.0
        image = image + (1.0 - weights_sum)[..., None] * bg_color
        return {"depth": depth, "image": image, "weights_sum": weights_sum,
                "weights": weights, "z_vals": z_vals}

    @traced("render")
    def run(self, rays_o, rays_d, time, *, cal_lidar_color=False,
            perturb=False, generator=None,
            z_noise: Optional[torch.Tensor] = None,
            resample_u: Optional[torch.Tensor] = None, bg_color=None,
            skip_warp=False):
        """Dense uniform rendering of a flat batch of rays
        (``renderer.py:203-285``): T = ``num_steps`` samples per ray from
        near to far, the field at all N x T points, composited.

        With ``perturb``, ``z_noise`` [N, T] (uniform in [0, 1)) replaces
        the jitter's draws from ``generator``; with ``upsample_steps``,
        ``resample_u`` [N, upsample_steps] replaces the resampling's draws
        (evenly spaced without ``perturb``, as the reference's keyless
        render)."""
        N = rays_o.shape[0]
        T = self.num_steps
        dev = rays_o.device
        aabb = self.aabb(dev)
        nears, fars = self._near_far(rays_o, rays_d, cal_lidar_color)
        # the candidates lie (far - near) / (T - 1) apart, sample_dist is
        # (far - near) / T: the reference's spacing, kept
        z_vals = nears + (fars - nears) * linspace01(T, dev)[None, :]
        sample_dist = (fars - nears) / T
        if perturb:
            z_noise = self.render_noise(N, None, generator, dev,
                                        {"z_noise": z_noise})["z_noise"]
            z_vals = z_vals + (z_noise - 0.5) * sample_dist
        if self.upsample_steps > 0:
            z_vals = self._importance_resample(
                rays_o, rays_d, time, z_vals, sample_dist, cal_lidar_color,
                det=not perturb, u=resample_u, generator=generator)

        xyzs = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        xyzs = torch.minimum(torch.maximum(xyzs, aabb[:3]), aabb[3:])
        dout = self._query_density(xyzs.reshape(-1, 3), time,
                                   cal_lidar_color, skip_warp=skip_warp)
        deltas = torch.cat([z_vals[..., 1:] - z_vals[..., :-1],
                            sample_dist.expand(N, 1)], dim=-1)
        return self._composite(rays_d, xyzs, z_vals, deltas, dout,
                               cal_lidar_color=cal_lidar_color,
                               bg_color=bg_color)

    @torch.no_grad()
    def _importance_resample(self, rays_o, rays_d, time, z_vals, sample_dist,
                             cal_lidar_color, *, det, u=None, generator=None):
        """A coarse pass over ``z_vals``, ``upsample_steps`` depths drawn from
        its weights, merged and sorted (``renderer.py:731-753``; its alphas
        take no active-sensor exponent, as there)."""
        N, T = z_vals.shape
        aabb = self.aabb(rays_o.device)
        xyzs = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        xyzs = torch.minimum(torch.maximum(xyzs, aabb[:3]), aabb[3:])
        sigmas = self.field.density(
            xyzs.reshape(-1, 3), time, cal_lidar_color=cal_lidar_color,
            compute_dtype=self.compute_dtype)["sigma"].reshape(N, T)
        deltas = torch.cat([z_vals[..., 1:] - z_vals[..., :-1],
                            sample_dist.expand(N, 1)], dim=-1)
        alphas = 1.0 - torch.exp(-deltas * self.density_scale * sigmas)
        trans = torch.cumprod(
            torch.cat([torch.ones((N, 1), device=z_vals.device),
                       1.0 - alphas + 1e-15], dim=-1), dim=-1)[:, :-1]
        weights = alphas * trans
        new_z = sample_pdf(z_vals, weights[:, :-1], self.upsample_steps,
                           det=det, u=u, generator=generator)
        return torch.sort(torch.cat([z_vals, new_z], dim=-1), dim=-1).values

    @traced("render")
    def run_occupancy(self, rays_o, rays_d, time, occ: OccupancyGrid,
                      occ_grid, *, num_steps_occ: int,
                      cal_lidar_color=False, perturb=False, generator=None,
                      z_noise: Optional[torch.Tensor] = None,
                      jitter_u: Optional[torch.Tensor] = None,
                      bg_color=None, occ_thresh: float = 0.01,
                      skip_warp=False):
        """T uniform candidates per ray, compacted to the K occupied ones,
        the field evaluated at N x K points and composited.

        With ``perturb``, ``z_noise`` [N, T] and ``jitter_u`` [N, K]
        (uniform in [0, 1)) replace the draws from ``generator``."""
        N = rays_o.shape[0]
        T = self.num_steps
        K = num_steps_occ
        dev = rays_o.device
        aabb = self.aabb(dev)
        nears, fars = self._near_far(rays_o, rays_d, cal_lidar_color)

        z_cand = nears + (fars - nears) * linspace01(T, dev)[None, :]
        sample_dist = (fars - nears) / T
        if perturb:
            dr = self.render_noise(N, K, generator, dev,
                                   {"z_noise": z_noise, "jitter_u": jitter_u})
            z_cand = z_cand + (dr["z_noise"] - 0.5) * sample_dist

        z_vals, valid = occ.compact_samples(occ_grid, rays_o, rays_d, z_cand,
                                            K, occ_thresh)
        if perturb and self.occ_jitter:
            z_vals = stratified_segment_jitter(z_vals, sample_dist, T, K,
                                               dr["jitter_u"])

        xyzs = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        xyzs = torch.minimum(torch.maximum(xyzs, aabb[:3]), aabb[3:])
        dout = self._query_density(xyzs.reshape(-1, 3), time,
                                   cal_lidar_color, skip_warp=skip_warp)
        deltas = torch.cat([z_vals[..., 1:] - z_vals[..., :-1],
                            sample_dist.expand(N, 1)], dim=-1)
        deltas = torch.minimum(deltas.clamp_min(0.0),
                               self._occ_delta_cap(sample_dist, T, K))
        return self._composite(rays_d, xyzs, z_vals, deltas, dout,
                               cal_lidar_color=cal_lidar_color,
                               bg_color=bg_color, valid=valid)

    @traced("render")
    def run_joint(self, ro_l, rd_l, ro_c, rd_c, time, *, perturb=False,
                  generator=None, draws_l: Optional[dict] = None,
                  draws_c: Optional[dict] = None, bg_color=None,
                  occ: Optional[OccupancyGrid] = None, occ_grid_l=None,
                  occ_grid_c=None, num_steps_occ: Optional[int] = None,
                  occ_thresh: float = 0.01, x_flow_extra=None):
        """A LiDAR and a camera ray batch rendered in one pass, each encoder
        family run once for both (``NVSFField.density_joint``;
        ``nvsf_tpu/render/renderer.py:382-500``). Per branch the samples
        and the quadrature are those of ``run``, or of ``run_occupancy``
        when ``occ`` and the grids are given (one K for both branches).
        With ``perturb``, ``draws_l`` / ``draws_c`` hold each branch's
        ``z_noise`` [N, T] and ``jitter_u`` [N, K] in place of draws from
        ``generator``.

        Returns (lidar_out, camera_out, extra): ``extra["flow_extra"]``
        carries the flow at ``x_flow_extra`` when given."""
        T = self.num_steps
        dev = ro_l.device
        aabb = self.aabb(dev)
        use_occ = occ is not None and occ_grid_l is not None
        K = num_steps_occ if use_occ else T
        branches = []
        for ro, rd, lidar, grid, dr in ((ro_l, rd_l, True, occ_grid_l,
                                         draws_l), (ro_c, rd_c, False,
                                                    occ_grid_c, draws_c)):
            nears, fars = self._near_far(ro, rd, lidar)
            z = nears + (fars - nears) * linspace01(T, dev)[None, :]
            sample_dist = (fars - nears) / T
            if perturb:
                dr = self.render_noise(ro.shape[0], K if use_occ else None,
                                       generator, dev, dr)
                z = z + (dr["z_noise"] - 0.5) * sample_dist
            valid = None
            if use_occ:
                z, valid = occ.compact_samples(grid, ro, rd, z, K,
                                               occ_thresh)
                if perturb and self.occ_jitter:
                    z = stratified_segment_jitter(z, sample_dist, T, K,
                                                  dr["jitter_u"])
            xyz = ro[:, None, :] + rd[:, None, :] * z[..., None]
            xyz = torch.minimum(torch.maximum(xyz, aabb[:3]), aabb[3:])
            branches.append((rd, xyz, z, sample_dist, valid, lidar))
        dout = self.field.density_joint(
            branches[0][1].reshape(-1, 3), branches[1][1].reshape(-1, 3),
            time, compute_dtype=self.compute_dtype,
            x_flow_extra=x_flow_extra)
        outs = []
        for (rd, xyz, z, sample_dist, valid, lidar), sfx in zip(
                branches, ("_l", "_c")):
            deltas = torch.cat([z[..., 1:] - z[..., :-1],
                                sample_dist.expand(z.shape[0], 1)], dim=-1)
            if use_occ:
                deltas = torch.minimum(deltas.clamp_min(0.0),
                                       self._occ_delta_cap(sample_dist, T,
                                                           K))
            outs.append(self._composite(
                rd, xyz, z, deltas, {"sigma": dout["sigma" + sfx],
                                     "geo_feat": dout["geo_feat" + sfx]},
                cal_lidar_color=lidar, bg_color=bg_color, valid=valid))
        extra = {"flow_extra": dout["flow_extra"]} \
            if "flow_extra" in dout else {}
        return outs[0], outs[1], extra

    # ------------------------------------------------------------------
    # eval: the streaming early-exit marcher and the frame renders (no
    # gradient). On the card each replays this renderer's captured graphs
    # (``render/frame_graph.py``), the counterpart of the JAX package's
    # jitted renders; on the CPU each runs eagerly.
    # ------------------------------------------------------------------
    @property
    def frame_graphs(self) -> FrameGraphs:
        """This renderer's captured frame renders, made at first use."""
        if self._frame_graphs is None:
            self._frame_graphs = FrameGraphs(self)
        return self._frame_graphs

    def drop_frame_graphs(self) -> None:
        """Forget the captured frame renders (the pools that every
        renderer's graphs share are freed with the last of them): a graph
        reads the field's parameters and the occupancy grid at the
        addresses they had at its capture."""
        self._frame_graphs = None

    def slab_counter(self, device) -> torch.Tensor:
        """``slabs_run`` on ``device``, made there at first use."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self.slabs_run is None or self.slabs_run.device != device:
            self.slabs_run = torch.zeros((), dtype=torch.int64, device=device)
        return self.slabs_run

    @torch.no_grad()
    def run_occupancy_stream(self, rays_o, rays_d, time, occ: OccupancyGrid,
                             occ_grid, *, num_steps_occ: int,
                             cal_lidar_color=False, bg_color=None,
                             occ_thresh: float = 0.01, slab: int = 32,
                             trans_eps: float = 1e-4, skip_warp=False):
        """Occupancy rendering with alive-ray early termination
        (``renderer.py:502-553``): the K compacted samples are composited
        in z-ordered slabs of ``slab``, stopping once every ray has
        transmittance below ``trans_eps`` or no occupied sample ahead.
        Quadrature is that of ``run_occupancy``; eval only. On the card a
        replay of the graph captured for this batch (``FrameGraphs.stream``).
        """
        kw = dict(num_steps_occ=num_steps_occ,
                  cal_lidar_color=cal_lidar_color, bg_color=bg_color,
                  occ_thresh=occ_thresh, slab=slab, trans_eps=trans_eps,
                  skip_warp=skip_warp)
        if rays_o.is_cuda:
            return self.frame_graphs.stream(rays_o, rays_d, time, occ,
                                            occ_grid, **kw)
        return self.stream_batch(rays_o, rays_d, time, occ, occ_grid, **kw)

    @torch.no_grad()
    def stream_batch(self, rays_o, rays_d, time, occ: OccupancyGrid,
                     occ_grid, *, num_steps_occ, cal_lidar_color, bg_color,
                     occ_thresh, slab, trans_eps, skip_warp, slab_steps=None):
        """``run_occupancy_stream`` of one batch without graphs, on the
        batch's device; ``slab_steps`` runs the slab loop (by default
        ``_slab_steps``; the frame graphs pass theirs at capture)."""
        T = self.num_steps
        nears, fars = self._near_far(rays_o, rays_d, cal_lidar_color)
        z_cand = nears + (fars - nears) * linspace01(T, rays_o.device)[None]
        sample_dist = (fars - nears) / T
        z_vals, valid = occ.compact_samples(occ_grid, rays_o, rays_d, z_cand,
                                            num_steps_occ, occ_thresh)
        depth, image, weights_sum = self._stream_composite(
            rays_o, rays_d, time, z_vals, valid, sample_dist,
            cal_lidar_color=cal_lidar_color, slab=min(slab, num_steps_occ),
            trans_eps=trans_eps, skip_warp=skip_warp, slab_steps=slab_steps)
        if cal_lidar_color:
            return {"depth_lidar": depth, "image_lidar": image,
                    "weights_sum_lidar": weights_sum}
        if bg_color is None:
            bg_color = 1.0
        image = image + (1.0 - weights_sum)[..., None] * bg_color
        return {"depth": depth, "image": image, "weights_sum": weights_sum}

    def _slab_steps(self, n: int, alive, body) -> None:
        """The marcher's loop without graphs, JAX's
        ``lax.while_loop(slab_cond, slab_body)``: for i < n, ``body(i,
        gate)`` runs where the device bool ``alive(i)`` holds.
          - On the CPU the host reads the bool (``slab_checks``) and skips
            the body where it is false (``gate`` None).
          - On the card (the eager render that the graphs are held to, and
            their warm-up) every body runs, with ``gate`` the bool: it
            writes its carry through ``torch.where(gate, ...)`` and so
            leaves it as it was where the bool is false.
        A capture passes its own loop instead (``FrameGraphs._slab_steps``:
        each body a conditional IF node). The body writes its carry in
        place: a skipped IF node writes nothing, and the code after the
        loop reads the carry's tensors."""
        for i in range(n):
            pred = alive(i)
            if not pred.is_cuda:
                self.slab_checks += 1
                if bool(pred):
                    body(i, None)
            else:
                body(i, pred)

    @torch.no_grad()
    def _stream_composite(self, rays_o, rays_d, time, z_vals, valid,
                          sample_dist, *, cal_lidar_color, slab,
                          trans_eps=1e-4, skip_warp=False, slab_steps=None):
        """Early-exit slab compositor over pre-compacted samples
        (``renderer.py:555-635``), in the shape of JAX's ``slab_body`` and
        ``slab_cond``: the carry (transmittance, depth, image, weight sum)
        is made before the loop and each slab updates it in place; before
        slab i the predicate "a ray is alive", (trans > trans_eps) &
        (m > i * S), is a bool on the device. Once false it stays false
        (trans does not grow, and m > i * S only falls as i rises), so the
        K // S steps of ``slab_steps`` (by default ``_slab_steps``) with the
        later ones skipped are the while_loop with its exit. Each slab
        evaluates the field at every ray of the batch, and adds one to
        ``slabs_run``."""
        N, K = z_vals.shape
        T = self.num_steps
        S = slab
        dev = rays_o.device
        aabb = self.aabb(dev)
        deltas = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                            sample_dist.expand(N, 1)], dim=-1)
        deltas = torch.minimum(deltas.clamp_min(0.0),
                               self._occ_delta_cap(sample_dist, T, K))
        if K % S:
            # pad to a slab multiple with dead samples: a floor K // S would
            # drop the far tail of every ray (renderer.py:574-587)
            padk = S - K % S
            z_vals = torch.cat([z_vals, z_vals[:, -1:].expand(N, padk)], -1)
            deltas = torch.cat([deltas, deltas.new_zeros((N, padk))], -1)
            valid = torch.cat([valid, valid.new_zeros((N, padk))], -1)
            K += padk
        m = valid.sum(dim=-1)
        exponent = 2.0 if self.active_sensor else 1.0
        out_dim = 2 if cal_lidar_color else 3
        trans = torch.ones((N,), device=dev)
        depth = torch.zeros((N,), device=dev)
        image = torch.zeros((N, out_dim), device=dev)
        wsum = torch.zeros((N,), device=dev)
        slabs_run = self.slab_counter(dev)

        def alive(i):
            return ((trans > trans_eps) & (m > i * S)).any()

        def slab_body(i, gate):
            sl = slice(i * S, (i + 1) * S)
            zs, ds, vs = z_vals[:, sl], deltas[:, sl], valid[:, sl]
            xyzs = rays_o[:, None, :] + rays_d[:, None, :] * zs[..., None]
            xyzs = torch.minimum(torch.maximum(xyzs, aabb[:3]), aabb[3:])
            dout = self.field.density(xyzs.reshape(-1, 3), time,
                                      cal_lidar_color=cal_lidar_color,
                                      compute_dtype=self.compute_dtype,
                                      skip_warp=skip_warp)
            sigmas = torch.where(vs, dout["sigma"].reshape(N, S), 0.0)
            alphas = 1.0 - torch.exp(-exponent * ds * self.density_scale
                                     * sigmas)
            # transmittance continues from the previous slabs
            t_in = torch.cumprod(torch.cat(
                [torch.ones((N, 1), device=dev), 1.0 - alphas + 1e-15],
                dim=-1), dim=-1)
            weights = alphas * trans[:, None] * t_in[:, :-1]
            dirs = rays_d[:, None, :].expand(N, S, 3)
            mask = ((weights > 1e-4) & vs).reshape(-1)
            rgbs = self.field.color(xyzs.reshape(-1, 3), dirs.reshape(-1, 3),
                                    dout["geo_feat"],
                                    cal_lidar_color=cal_lidar_color,
                                    mask=mask,
                                    compute_dtype=self.compute_dtype)
            rgbs = rgbs.reshape(N, S, out_dim)

            def gated(x, idle):
                return x if gate is None else torch.where(gate, x, idle)

            depth.add_(gated((weights * zs).sum(dim=-1), 0.0))
            image.add_(gated((weights[..., None] * rgbs).sum(dim=-2), 0.0))
            wsum.add_(gated(weights.sum(dim=-1), 0.0))
            trans.mul_(gated(t_in[:, -1], 1.0))
            slabs_run.add_(1 if gate is None else gate)

        (slab_steps or self._slab_steps)(K // S, alive, slab_body)
        return depth, image, wsum

    # ------------------------------------------------------------------
    # a frame in stages: before the chunks, the chunks, after them (the
    # frame graphs capture each stage as its own graph)
    # ------------------------------------------------------------------
    def chunk_rays(self, n: int) -> int:
        """Rays per render chunk of a frame stage of ``n`` rows."""
        return min(self.max_ray_batch, n)

    def frame_outputs(self, n: int, cal_lidar_color, wsum=False) -> tuple:
        """Zeroed depth [n], image [n, 2 or 3] (and weight sum [n]): the
        buffers that the chunks of a frame write."""
        out_dim = 2 if cal_lidar_color else 3
        dev = next(self.field.parameters()).device
        outs = (torch.zeros((n,), device=dev),
                torch.zeros((n, out_dim), device=dev))
        return outs + (torch.zeros((n,), device=dev),) if wsum else outs

    @torch.no_grad()
    def occ_frame_pre(self, rays_o, rays_d, occ: OccupancyGrid, occ_grid,
                      K, occ_thresh, cal_lidar_color):
        """The occupancy frame before the marcher (``renderer.py:660-703``):
        compaction of all rays in chunks of ``COMPACT_CHUNK``, a stable sort
        by the occupied-sample count m (homogeneous early-exit chunks, the
        same chunk membership as ``jnp.argsort``) and padding to whole
        chunks of ``chunk_rays``. Returns (rays_o, rays_d, z_vals, valid,
        sample_dist) sorted and padded, and the inverse order [Np]."""
        N = rays_o.shape[0]
        T = self.num_steps
        dev = rays_o.device
        nears, fars = self._near_far(rays_o, rays_d, cal_lidar_color)
        sample_dist = (fars - nears) / T

        def pad(a, n, fill=0.0):
            return torch.cat([a, a.new_full((n,) + a.shape[1:], fill)])

        CC = min(COMPACT_CHUNK, N)
        Np = -(-N // CC) * CC
        ro_p, rd_p = pad(rays_o, Np - N), pad(rays_d, Np - N, 1.0)
        nr_p, fr_p = pad(nears, Np - N), pad(fars, Np - N, 1.0)
        lin = linspace01(T, dev)[None, :]
        z_sel = torch.empty((Np, K), device=dev)
        valid = torch.empty((Np, K), dtype=torch.bool, device=dev)
        for c in range(0, Np, CC):
            z = nr_p[c:c + CC] + (fr_p[c:c + CC] - nr_p[c:c + CC]) * lin
            zc, vc = occ.compact_samples(occ_grid, ro_p[c:c + CC],
                                         rd_p[c:c + CC], z, K, occ_thresh)
            z_sel[c:c + CC] = zc
            valid[c:c + CC] = vc
        valid &= (torch.arange(Np, device=dev) < N)[:, None]    # kill pads
        m = valid.sum(dim=-1)
        order = torch.argsort(m, stable=True)
        inv = torch.argsort(order)
        C = self.chunk_rays(Np)
        pad2 = -(-Np // C) * C - Np

        def sort_pad(a, fill=0.0):
            return pad(a[order], pad2, fill)

        return (sort_pad(ro_p), sort_pad(rd_p, 1.0), sort_pad(z_sel),
                sort_pad(valid, False),
                sort_pad(pad(sample_dist, Np - N, 1.0))), inv

    @torch.no_grad()
    def occ_frame_post(self, depth_s, image_s, wsum_s, inv, N,
                       cal_lidar_color, bg_color) -> dict:
        """The occupancy frame after the marcher: the chunks' outputs
        unsorted, the camera's background composited."""
        Np = inv.shape[0]
        depth, image, wsum = (a[:Np][inv][:N]
                              for a in (depth_s, image_s, wsum_s))
        if cal_lidar_color:
            return {"depth_lidar": depth, "image_lidar": image}
        if bg_color is None:
            bg_color = 1.0
        image = image + (1.0 - wsum)[..., None] * bg_color
        return {"depth": depth, "image": image}

    def dense_frame_pre(self, rays_o, rays_d):
        """The dense frame's rays padded to whole chunks of ``chunk_rays``
        (origin 0, direction 1, ``renderer.py:790-797``)."""
        N = rays_o.shape[0]
        pad = -(-N // self.chunk_rays(N)) * self.chunk_rays(N) - N
        return (torch.cat([rays_o, rays_o.new_zeros((pad, 3))]),
                torch.cat([rays_d, rays_d.new_ones((pad, 3))]))

    @torch.no_grad()
    def occ_chunk(self, rays_o, rays_d, time, z_vals, valid, sample_dist,
                  cal_lidar_color, slab, skip_warp=False,
                  slab_steps=None) -> tuple:
        """One chunk of sorted rays through the early-exit marcher
        (``_stream_composite``, its slab loop run by ``slab_steps``):
        (depth, image, weight sum)."""
        return self._stream_composite(
            rays_o, rays_d, time, z_vals, valid, sample_dist,
            cal_lidar_color=cal_lidar_color, slab=slab, skip_warp=skip_warp,
            slab_steps=slab_steps)

    @torch.no_grad()
    def dense_chunk(self, rays_o, rays_d, time, cal_lidar_color, bg_color,
                    skip_warp=False) -> tuple:
        """One dense chunk through ``run`` without jitter: (depth,
        image)."""
        out = self.run(rays_o, rays_d, time, cal_lidar_color=cal_lidar_color,
                       bg_color=bg_color, skip_warp=skip_warp)
        if cal_lidar_color:
            return out["depth_lidar"], out["image_lidar"]
        return out["depth"], out["image"]

    @torch.no_grad()
    def _render_staged_occ(self, rays_o, rays_d, time, occ: OccupancyGrid,
                           occ_grid, K, occ_thresh, cal_lidar_color,
                           bg_color, skip_warp=False):
        """Full-frame occupancy render with occupancy-sorted chunking
        (``renderer.py:638-728``), eagerly: ``occ_frame_pre``, the
        early-exit marcher over chunks of ``max_ray_batch`` sorted rays,
        ``occ_frame_post``."""
        S = min(self.stream_slab, K)
        ins, inv = self.occ_frame_pre(rays_o, rays_d, occ, occ_grid, K,
                                      occ_thresh, cal_lidar_color)
        outs = self.frame_outputs(ins[0].shape[0], cal_lidar_color, True)

        def chunk(ro, rd, z, v, sd):
            return self.occ_chunk(ro, rd, time, z, v, sd, cal_lidar_color,
                                  S, skip_warp)

        run_chunks(self.chunk_rays(inv.shape[0]), chunk, ins, outs)
        return self.occ_frame_post(*outs, inv, rays_o.shape[0],
                                   cal_lidar_color, bg_color)

    @torch.no_grad()
    def _render_dense(self, rays_o, rays_d, time, cal_lidar_color, bg_color,
                      skip_warp=False):
        """Full-frame dense render, eagerly: chunks of ``max_ray_batch`` rays
        through ``run`` without jitter (``renderer.py:783-800``; the last
        chunk padded, as there)."""
        N = rays_o.shape[0]
        ins = self.dense_frame_pre(rays_o, rays_d)
        outs = self.frame_outputs(ins[0].shape[0], cal_lidar_color)
        run_chunks(self.chunk_rays(N), lambda ro, rd: self.dense_chunk(
            ro, rd, time, cal_lidar_color, bg_color, skip_warp), ins, outs)
        keys = (("depth_lidar", "image_lidar") if cal_lidar_color
                else ("depth", "image"))
        return {k: o[:N] for k, o in zip(keys, outs)}

    def render(self, rays_o, rays_d, time, *, cal_lidar_color=False,
               bg_color=None, occ: Optional[OccupancyGrid] = None,
               occ_grid=None, num_steps_occ=None, occ_thresh: float = 0.01,
               skip_warp=False):
        """Flat [N, 3] ray batch -> depth and image, the JAX package's
        ``render(staged=True)`` (``renderer.py:756-800``): through the
        sorted-chunk early-exit marcher with an occupancy grid, through
        chunks of the dense ``run`` without one. On the card a replay of
        this renderer's frame graphs (``FrameGraphs.render``), on the CPU
        eagerly (``render_eager``)."""
        kw = dict(cal_lidar_color=cal_lidar_color, bg_color=bg_color,
                  occ=occ, occ_grid=occ_grid, num_steps_occ=num_steps_occ,
                  occ_thresh=occ_thresh, skip_warp=skip_warp)
        if rays_o.is_cuda:
            return self.frame_graphs.render(rays_o, rays_d, time, **kw)
        return self.render_eager(rays_o, rays_d, time, **kw)

    def render_eager(self, rays_o, rays_d, time, *, cal_lidar_color=False,
                     bg_color=None, occ: Optional[OccupancyGrid] = None,
                     occ_grid=None, num_steps_occ=None,
                     occ_thresh: float = 0.01, skip_warp=False):
        """``render`` without graphs, on the rays' device."""
        if occ is None or occ_grid is None:
            return self._render_dense(rays_o, rays_d, time, cal_lidar_color,
                                      bg_color, skip_warp=skip_warp)
        return self._render_staged_occ(
            rays_o, rays_d, time, occ, occ_grid, num_steps_occ, occ_thresh,
            cal_lidar_color, bg_color, skip_warp=skip_warp)

