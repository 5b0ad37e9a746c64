"""The JAX package's last jitted programs in the port, on the CPU, where
they run eagerly (on the card each replays a CUDA graph, ``train/graphs.py``;
``tests/test_torch_cuda.py`` holds the replays to the eager versions):

- the occupancy refresh (``_occ_update``): the trainer's one refresh
  generator, reseeded in place before each refresh, draws what a fresh
  generator seeded as before draws, and the refreshed grids match JAX's
  ``_occ_update`` given those draws;
- the U-Net refine step (``step_fn``): the tensor learning rate each step
  reads follows ``onecycle_lr`` and JAX's ``sched``;
- the mesh export's density query (``q``): every query sees ``chunk``
  points, the last chunk padded, and the grid matches JAX's;
- the EMA update (``_update_ema``): one multi-tensor pass, bit-equal to the
  loop over the parameters and within 1e-7 of JAX's;
- the graphed entry points raise on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsf_tpu.config import NVSFConfig as JaxConfig
from nvsf_tpu.data.synthetic import SyntheticSceneSpec as JaxSceneSpec
from nvsf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from nvsf_tpu.render import export as jexport
from nvsf_tpu.train import refine as jrefine
from nvsf_tpu.train.trainer import Trainer as JaxTrainer
from nvsf_torch import bridge
from nvsf_torch.render import export as texport
from nvsf_torch.train import refine as trefine
from nvsf_torch.train.graphs import Program

from test_torch_models import one_torch_thread  # noqa: F401
from test_torch_scan import FRAMES, SPEC, _config, _port

FWD = dict(rtol=1e-4, atol=1e-5)


def _pair(tmp_path, **over):
    """A toy JAX trainer and the port's trainer on its state, the grids
    random in [0, 2) (a refresh then keeps some old values and takes the
    field's density in others)."""
    jtr = JaxTrainer(JaxConfig.from_dict(_config(4, **over)),
                     jax_scene(JaxSceneSpec(num_frames=FRAMES, **SPEC),
                               split="train"),
                     workspace=str(tmp_path))
    rng = np.random.default_rng(0)
    for k in ("occ_grid_lidar", "occ_grid_rgb"):
        jtr.state[k] = jnp.asarray(rng.uniform(
            0, 2, jtr.state[k].shape).astype(np.float32))
    tr = _port(4, **over)
    bridge.load_trainer_state(tr, jax.tree.map(np.asarray, jtr.state))
    return jtr, tr


def test_refresh_draws_as_a_fresh_generator_and_matches_jax(tmp_path):
    """Two refreshes through ``maybe_update_occ``: each draws the times,
    cells and jitter that a fresh ``torch.Generator`` seeded with 0xACC +
    global_step draws in the same order (the port's draws before the
    trainer kept one generator), so each grid equals the refresh computed
    from that fresh generator bit for bit; and each grid matches JAX's
    ``_occ_update`` given those times, cells and jitter, at every cell
    drawn at most once (a cell drawn twice takes any of its writes in
    JAX)."""
    jtr, tr = _pair(tmp_path)
    occ = tr.occ
    M = occ.n_cells // occ.update_fraction
    for step in (4, 8):
        before = {k: getattr(tr, f"occ_grid_{k}").clone()
                  for k in ("lidar", "rgb")}
        gen = torch.Generator().manual_seed(0xACC + step)
        ts = tr._occ_refresh_times(gen)
        draws = {k: (torch.randint(0, occ.n_cells, (M,), generator=gen),
                     torch.rand((M, 3), generator=gen))
                 for k in ("lidar", "rgb")}
        tr.global_step = step
        tr.maybe_update_occ()
        assert tr.occ_refresh_count == step // 4
        for k, lidar in (("lidar", True), ("rgb", False)):
            cells, u = draws[k]
            got = getattr(tr, f"occ_grid_{k}")
            ref = occ.update(before[k], lambda p, t, lidar=lidar:
                             tr.field.density(p, t, cal_lidar_color=lidar,
                                              skip_warp=True)["sigma"],
                             ts, cells=cells, jitter_u=u)
            assert torch.equal(got, ref), k
            # JAX's refresh on these draws: its two draw calls patched,
            # op by op (a jitted call would keep its first trace's draws)
            orig = jax.random.randint, jax.random.uniform
            try:
                jax.random.randint = lambda *a, **kw: jnp.asarray(
                    cells.numpy().astype(np.int32))
                jax.random.uniform = lambda *a, **kw: jnp.asarray(u.numpy())
                with jax.disable_jit():
                    jgrid = np.asarray(jtr._occ_update(
                        jtr.state["params"], jnp.asarray(before[k].numpy()),
                        jax.random.PRNGKey(step), jnp.asarray(ts.numpy()),
                        lidar))
            finally:
                jax.random.randint, jax.random.uniform = orig
            once = np.bincount(cells.numpy(), minlength=occ.n_cells) <= 1
            assert (~once).sum() < M // 4 and (got != before[k]).any()
            np.testing.assert_allclose(got.numpy().reshape(-1)[once],
                                       jgrid.reshape(-1)[once], **FWD,
                                       err_msg=k)


def test_refine_rate_follows_onecycle_and_jax():
    """The rate that each step of a 1000-step refine stage reads (the
    Adam group's tensor, filled in place before the step) equals
    ``onecycle_lr`` at that step within 1e-7 of the rate (the f32 tensor
    rounds it by 6e-8 at most), and JAX's ``sched`` within 2 f32 ulps of
    the peak rate: JAX evaluates the schedule in f32, whose cosine and sums
    stray from the exact rate by up to 1.3 ulps of the peak (1.5e-10 at a
    peak of 1e-3), and from the port's f32 rate by 1 ulp."""
    steps, lr = 1000, 1e-3
    x = torch.zeros((1, 3, 16, 16))
    rs = trefine.RefineSteps(trefine.UNet(3, 8, 1), x, x[:, :1], steps=steps,
                             lr=lr)
    assert rs.program is None and not rs.lr.is_cuda
    seen = []
    rs.body = lambda draws=None: seen.append(
        float(rs.opt.param_groups[0]["lr"]))
    for i in range(steps):
        rs.step(i)
    host = [trefine.onecycle_lr(lr, steps)(i) for i in range(steps)]
    ref = np.asarray(jax.vmap(jrefine.onecycle_lr(lr, steps))(
        jnp.arange(steps)))
    np.testing.assert_allclose(seen, host, rtol=1e-7, atol=0)
    np.testing.assert_allclose(seen, ref, rtol=0,
                               atol=2 * float(np.spacing(np.float32(lr))))
    assert max(seen) == pytest.approx(lr) and seen[0] == pytest.approx(
        lr / 25)


def test_density_grid_pads_its_last_chunk_as_jax(tmp_path):
    """A grid of 7 x 5 x 3 = 105 points in chunks of 40: three queries of
    40 points each, the last padded, as JAX's ``q`` is called; the grid
    matches JAX's within ``test_mesh_export_matches_jax``'s tolerance."""
    jtr, tr = _pair(tmp_path)
    kw = dict(bound_min=(-0.6, -0.5, -0.4), bound_max=(0.5, 0.6, 0.3),
              xyz_res=(7, 5, 3), t=0.3)
    ref = jexport.extract_density_grid(jtr, chunk=40, **kw)
    sizes = []
    density = tr.ema_field.density

    def spy(pts, t, **k):
        sizes.append(pts.shape[0])
        return density(pts, t, **k)

    tr.ema_field.density = spy
    got = texport.extract_density_grid(tr, chunk=40, **kw)
    assert sizes == [40, 40, 40] and got.shape == (7, 5, 3)
    np.testing.assert_allclose(got, ref, **FWD)


def test_ema_update_is_one_pass_of_the_loop_and_jax(tmp_path):
    """``Trainer.update_ema`` against the loop it replaced (bit for bit)
    and JAX's ``_update_ema`` within two f32 ulps of the sum of the
    magnitudes of each entry's terms, decay * |ema| + (1 - decay) *
    |params|: XLA may round the two products and the sum in another way
    than the port's ``mul_`` and ``add_``, each rounding moving the entry
    by half an ulp of that sum (1e-7 of each tensor's max is below what f32
    resolves: an ulp is 6e-8 to 1.2e-7 of a value)."""
    jtr, tr = _pair(tmp_path, ema_decay=0.9)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for k, p in tr.field.named_parameters():
            tr.ema[k].copy_(torch.from_numpy(rng.standard_normal(
                tuple(p.shape)).astype(np.float32)))
    ema0 = {k: v.clone() for k, v in tr.ema.items()}
    params = {k: p.detach().numpy().copy()
              for k, p in tr.field.named_parameters()}
    loop = {k: v.clone().mul_(0.9).add_(torch.from_numpy(params[k]),
                                         alpha=1 - 0.9)
            for k, v in ema0.items()}
    tr.update_ema()
    ref = jtr._update_ema({k: v.numpy() for k, v in ema0.items()}, params)
    for k, v in tr.ema.items():
        assert torch.equal(v, loop[k]), k
        terms = 0.9 * np.abs(ema0[k].numpy()) + 0.1 * np.abs(params[k])
        err = np.abs(v.numpy() - np.asarray(ref[k]))
        assert (err <= 2 * np.spacing(terms.astype(np.float32))).all(), k


@pytest.mark.parametrize("program", ["refresh", "refine", "density query",
                                     "program"])
def test_graphed_entry_points_raise_on_the_cpu(program):
    """``graphed=True`` on a CPU trainer raises, as ``StepGraphs`` does;
    nothing falls back to the eager program."""
    with pytest.raises(ValueError, match="needs the card"):
        if program == "refresh":
            _port(4).refresh_occupancy(1, graphed=True)
        elif program == "refine":
            x = torch.zeros((1, 3, 16, 16))
            trefine.RefineSteps(trefine.UNet(3, 8, 1), x, x[:, :1], steps=2,
                                lr=1e-3, graphed=True)
        elif program == "density query":
            texport.extract_density_grid(_port(4), (-1, -1, -1), (1, 1, 1),
                                         (2, 2, 2), graphed=True)
        else:
            Program(lambda: None, "cpu")


def test_capture_holds_off_garbage_collection(monkeypatch):
    """Every capture (``graphs.capture``, which ``Program`` and the frame
    graphs use) runs with Python's cyclic collector off, and turns it back
    on after, also when the capture raises: a collection inside a capture
    could free a dropped program's pool on the capturing thread."""
    import contextlib
    import gc

    from nvsf_torch.train import graphs
    seen = []

    @contextlib.contextmanager
    def fake_graph(graph, **kwargs):
        seen.append((gc.isenabled(), kwargs))
        yield

    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    assert gc.isenabled()
    with graphs.capture(object(), stream="s"):
        assert not gc.isenabled()
    with pytest.raises(RuntimeError):
        with graphs.capture(object()):
            raise RuntimeError("capture failed")
    assert seen == [(False, {"stream": "s"}), (False, {})]
    assert gc.isenabled()
