"""The plain version of the port's halo kernels (``ops/halo_fused.py``),
without processes.

The plain halo iteration of every row block of a whole field, the ring
exchanges done by hand (``ring_iteration_plain``), must be the whole-field
plain stencil iteration (``ops/stencil_fused.stencil_iteration_plain``,
circular on both axes as the ring is): float64, 1e-12 relative to the
largest value, for halo depth 1 and 2, negative dx and dy, the four vertex
proxes and 1, 2 and 4 blocks.  One block's ``halo_fused_iteration`` on CPU
tensors, fed its neighbours' strips by a scripted exchange, must return
the same.  The JAX package's halo Pallas kernel is held against the same
solves in ``test_torch_halo.py`` (interpret mode).
"""
import numpy as np
import pytest
import torch

from cp_pfdr_graph_d1_tpu_torch.config import PFDROptions
from cp_pfdr_graph_d1_tpu_torch.ops import halo_fused as hf
from cp_pfdr_graph_d1_tpu_torch.ops.stencil_fused import \
    stencil_iteration_plain
from cp_pfdr_graph_d1_tpu_torch.solvers.pfdr_quadratic import fused_route

SHIFT_SETS = {
    "hd1": ((0, 1), (1, 0)),
    "hd2_negative_dx": ((0, 1), (1, 0), (2, 0), (1, -1)),
    "negative_dy": ((0, -1), (-2, 1), (1, 0)),
}
VPROXES = {"l1": ("l1", False), "l1+pos": ("l1", True),
           "bounds": ("bounds", False), "none+pos": ("none", True)}


def fields(shifts, h=8, w=6, seed=0):
    r = np.random.default_rng(seed)
    f = len(shifts)

    def t(*shape, lo=-1.0, hi=1.0):
        return torch.as_tensor(r.uniform(lo, hi, shape))

    w_d1u = t(f, h, w, lo=0.0)
    return (t(h, w), t(h, w), t(h, w, lo=0.05), t(h, w, lo=0.0, hi=0.1),
            t(f, h, w), t(f, h, w), t(f, h, w, lo=0.0, hi=0.5),
            t(f, h, w, lo=0.0, hi=0.5), w_d1u, 1.0 - w_d1u,
            t(f, h, w, lo=0.0, hi=0.3))


def kwargs(shifts, vprox):
    kind, pos = VPROXES[vprox]
    return dict(shifts=shifts, rho=1.3, vkind=kind, positivity=pos,
                lo=-0.5, hi=0.8)


def rel_err(a, b):
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))


@pytest.mark.parametrize("vprox", list(VPROXES))
@pytest.mark.parametrize("shifts", list(SHIFT_SETS))
def test_ring_iteration_matches_whole_field(shifts, vprox):
    sh = SHIFT_SETS[shifts]
    fl = fields(sh)
    kw = kwargs(sh, vprox)
    xn, zu, zv, num, den = stencil_iteration_plain(*fl, **kw)
    for p in (1, 2, 4):
        out = hf.ring_iteration_plain(*fl, num_shards=p, **kw)
        got = [torch.cat([o[0][0] for o in out]),
               torch.cat([o[0][1] for o in out], dim=1),
               torch.cat([o[0][2] for o in out], dim=1)]
        for g, ref in zip(got, (xn, zu, zv)):
            assert rel_err(g, ref) <= 1e-12, (p, rel_err(g, ref))
        assert rel_err(sum(o[0][3] for o in out), num) <= 1e-12
        assert rel_err(sum(o[0][4] for o in out), den) <= 1e-12


@pytest.mark.parametrize("shifts", list(SHIFT_SETS))
def test_block_iteration_on_cpu_is_the_plain_version(shifts):
    """``halo_fused_iteration`` on CPU tensors runs the plain stages around
    the exchange it is given, sends what its neighbours receive, and
    launches nothing."""
    sh = SHIFT_SETS[shifts]
    fl = fields(sh, h=12)
    kw = kwargs(sh, "l1")
    p = 3
    out = hf.ring_iteration_plain(*fl, num_shards=p, **kw)
    hd = max(abs(dy) for dy, _ in sh)
    before = hf.halo_fused_iteration.launches
    for b in range(p):
        rows = slice(4 * b, 4 * b + 4)
        blk = [a[..., rows, :].contiguous() for a in fl]
        ex = hf.ScriptedExchange(out[b][1])
        got = hf.halo_fused_iteration(*blk, hd=hd, exchange=ex, **kw)
        for g, ref in zip(got, out[b][0]):
            torch.testing.assert_close(g, ref, rtol=0, atol=0)
        # round 1 sent x and p of the last rows forward (what block b + 1
        # received from its previous block) and of the first rows back
        nxt, prv = out[(b + 1) % p][1], out[(b - 1) % p][1]
        torch.testing.assert_close(ex.sent[0][0], nxt[0][0], rtol=0, atol=0)
        torch.testing.assert_close(ex.sent[0][1], prv[0][1], rtol=0, atol=0)
        torch.testing.assert_close(ex.sent[1][0], nxt[1][0], rtol=0, atol=0)
        torch.testing.assert_close(ex.sent[1][1], prv[1][1], rtol=0, atol=0)
    assert hf.halo_fused_iteration.launches == before


def test_halo_depth_out_of_range_raises():
    sh = SHIFT_SETS["hd2_negative_dx"]
    fl = [a[..., :1, :].contiguous() for a in fields(sh)]
    with pytest.raises(ValueError, match="halo depth"):
        hf.halo_fused_iteration(*fl, hd=2, exchange=None, **kwargs(sh, "l1"))


class _Block:
    """Stand-in for a row block of a vertex-sharded stencil."""

    shifts = ((0, 1), (1, 0))
    supports_fused = False

    def __init__(self, halo_fused):
        self.supports_halo_fused = halo_fused

    def fused_iteration(self, *args):
        raise AssertionError("not called")


@pytest.mark.parametrize("halo_fused", [True, False])
def test_fused_route_takes_halo_blocks(halo_fused):
    """The quadratic loop routes a row block to the halo kernels when they
    take it (``supports_halo_fused``), as the JAX loop does."""
    obs = torch.zeros(3)
    assert fused_route(PFDROptions(fused="on"), _Block(halo_fused),
                       obs) is halo_fused
    assert fused_route(PFDROptions(fused="off"), _Block(halo_fused),
                       obs) is False
