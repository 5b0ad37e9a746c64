"""The U-Net refine step of the port (``nvsf_torch/train/refine.py``, the
eager ``RefineSteps``) against the benchmark's plain float32 reference
(``perfbench/reference/unet.py``) on the CPU, at the published widths
(channels 32-64-128-256-256, 8 heads, dropout 0.1) on small batches. At
34 x 66, whose sides are not multiples of 16, the ups pad to their skips
as at the stage's 66 x 1030.

One step on injected draws, then three steps on the draws each side takes
from its own generator: the output, the loss, every gradient, the BatchNorm
running statistics and the parameters after Adam's step. The states carry
random BatchNorm affine terms and statistics: at the initial identities a
batch-normalised layer's input gradient is a small remainder of cancelling
terms, and two float32 orders of summation part by ~0.2 % there (either
side against float64), which no tolerance below should have to hold.

Tolerances: the two sides sum convolutions and reductions in the same
float32 but not always in the same order (relative gaps ~1e-6 a layer), so
outputs and statistics are held to 1e-5, gradients to 1e-4 of each
parameter's largest, as ``test_torch_refine.py`` holds the port to the JAX
package. Adam's first steps move each weight by about the rate times the
sign of its gradient, so a gradient within rounding of zero may take
either sign: the update of each parameter is held in norm, to 1e-3 of the
reference's.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from nvsf_torch.models.unet import UNet  # noqa: E402
from nvsf_torch.train import refine as R  # noqa: E402
from perfbench.reference import unet as ref  # noqa: E402

from test_torch_models import one_torch_thread  # noqa: F401,E402

U = dict(in_channels=3, channels=32, out_channels=1, dropout=0.1,
         num_heads=8)
STAGE = dict(steps=1000, lr=1e-3, box_num_max=32, box_frac=0.1)


def _unet(seed):
    """A seeded U-Net with random BatchNorm affine terms and running
    statistics (the init's are identities)."""
    g = torch.Generator().manual_seed(seed)
    net = UNet(channels=U["channels"], generator=g)
    with torch.no_grad():
        for k, t in [*net.named_parameters(), *net.named_buffers()]:
            if k.endswith(("scale", "var")):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif k.endswith(("bias", "mean")):
                t.copy_(0.2 * torch.randn(t.shape, generator=g))
    return net


def _batch(shape, seed):
    g = torch.Generator().manual_seed(seed)
    B, _, H, W = shape
    gt = (torch.rand((B, 1, H, W), generator=g) > 0.4).float()
    drop = (gt + 0.3 * torch.randn(gt.shape, generator=g)).clamp(0, 1)
    x = torch.cat([drop, torch.rand((B, 2, H, W), generator=g)], dim=1)
    return x, gt


def _state(rs):
    """The state before a step, as the benchmark's entry keeps it."""
    adam = {}
    for k, p in rs.unet.named_parameters():
        st = rs.opt.state.get(p)
        adam[k] = {"exp_avg": st["exp_avg"].clone(),
                   "exp_avg_sq": st["exp_avg_sq"].clone(),
                   "step": float(st["step"])} if st else None
    return {"params": {k: p.detach().clone()
                       for k, p in rs.unet.named_parameters()},
            "buffers": {k: b.clone() for k, b in rs.unet.named_buffers()},
            "adam": adam}


def _compare(rs, loss, res, before):
    """The port's step (``rs`` after it, its ``loss``) against the
    reference's result ``res`` from the state ``before``."""
    torch.testing.assert_close(rs.out, res["out"], rtol=1e-5, atol=1e-5)
    assert loss == pytest.approx(res["loss"], rel=1e-5)
    for k, p in rs.unet.named_parameters():
        g = res["grads"][k]
        torch.testing.assert_close(p.grad, g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()),
                                   msg=k)
        moved = res["params"][k] - before["params"][k]
        gap = float((p.detach() - res["params"][k]).norm())
        assert gap <= 1e-3 * float(moved.norm()), (k, gap)
    for k, b in rs.unet.named_buffers():
        r = res["buffers"][k]
        torch.testing.assert_close(b, r, rtol=1e-5,
                                   atol=1e-6 * float(r.abs().max()), msg=k)


@pytest.mark.parametrize("shape", [(2, 3, 34, 66), (1, 3, 32, 48)],
                         ids=["padded", "even"])
def test_step_matches_the_reference_on_injected_draws(shape):
    x, gt = _batch(shape, 1)
    rs = R.refine_steps(_unet(0), x, gt, graphed=False, **{
        k: STAGE[k] for k in ("steps", "lr")})
    d = ref.draws(torch.Generator().manual_seed(9), shape, U, STAGE)
    before = _state(rs)
    loss, = rs.run(0, 1, log_every=1, draws=[d])
    with ref.exact():
        res = ref.step(before, x, gt, d, ref.onecycle(1e-3, 1000, 0), U,
                       STAGE)
    _compare(rs, loss, res, before)
    assert not rs.unet.training


def test_steps_draw_in_the_programs_order():
    """Three steps with no draws injected: the port draws from its own
    generator, the reference from one seeded alike, drawing each step's in
    turn; each step from the port's state before it (Adam's moments and
    count from the second on)."""
    shape = (2, 3, 34, 66)
    x, gt = _batch(shape, 2)
    rs = R.refine_steps(_unet(3), x, gt, graphed=False, **{
        k: STAGE[k] for k in ("steps", "lr")})
    states, after = [], []
    for k in range(3):
        states.append(_state(rs))
        loss, = rs.run(k, k + 1, log_every=1)
        after.append((loss, rs.out.clone(), _state(rs),
                      {n: p.grad.clone()
                       for n, p in rs.unet.named_parameters()}))
    results = ref.checked_steps(states, x, gt, U, STAGE)
    for before, (loss, out, state, grads), res in zip(states, after,
                                                      results):
        rs.out = out
        with torch.no_grad():
            for n, p in rs.unet.named_parameters():
                p.copy_(state["params"][n])
                p.grad.copy_(grads[n])
            for n, b in rs.unet.named_buffers():
                b.copy_(state["buffers"][n])
        _compare(rs, loss, res, before)
    # the draws differ from step to step: a reference that reused step 0's
    # draws would not hold the later steps
    d = [ref.draws(g, shape, U, STAGE) for g in
         [torch.Generator().manual_seed(ref.GENERATOR_SEED)] * 2]
    assert not torch.equal(d[0]["unet"]["attn"], d[1]["unet"]["attn"])


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.unet\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'nvsf_torch', 'nvsf_tpu', 'jax'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
