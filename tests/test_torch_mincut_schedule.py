"""The two schedules of the ``mincut_fused`` kernel, as plain PyTorch
mirrors, against ``pdhg_min_cut_plain`` on the CPU in float64, and the
function that chooses between them.

Schedule "stream" recomputes each cell's in-edge duals from the old state
instead of synchronising between the half-steps, and double-buffers xb and
z by step parity.  Schedule "shared" cuts the rows into bands; a band
reads ``hd`` halo rows on each side and recomputes the duals of the halo
edges whose head lies in it.  Both must give ``pdhg_min_cut_plain``'s
iterates bit for bit (``torch.equal``): their arithmetic is the same,
operation for operation, on values gathered from other places.  The fields
are 24 x 31 with weights on every slot (the circular wrap included), for
F = 2 and the four families (0, 1), (1, 0), (2, 0), (1, -1) of halo depth
2, from cold and warm starts, over 750 steps in chunks of 250.
"""
import numpy as np
import pytest
import torch

from cp_pfdr_graph_d1_tpu_torch.ops import mincut_fused as mf
from cp_pfdr_graph_d1_tpu_torch.ops.stencil_fused import _roll2

torch.set_num_threads(1)

H, W = 24, 31
SHIFTS = {2: ((0, 1), (1, 0)), 4: ((0, 1), (1, 0), (2, 0), (1, -1))}
STEPS, CHECK = 600, 250   # 3 chunks: 750 steps


def cut_inputs(f, warm, seed=0):
    """One cut's arguments on a circular 24 x 31 stencil: weights on every
    slot (10 % zero), standard-normal costs, the preconditioning of
    ``cut_problem``; tol -inf, so every chunk runs."""
    r = np.random.default_rng(seed)
    shifts = SHIFTS[f]
    w = np.where(r.random((f, H, W)) < 0.1, 0.0,
                 0.2 + 0.3 * r.random((f, H, W)))
    wt = torch.from_numpy(w)
    deg = sum(wt[k] + _roll2(wt[k], dy, dx)
              for k, (dy, dx) in enumerate(shifts))
    c = torch.from_numpy(r.standard_normal((H, W)))
    tau = torch.where(deg > 0, 1.0 / deg.clamp(min=1e-30),
                      1.0 / c.abs().clamp(min=1e-12))
    sigma = torch.where(wt > 0, 0.5 / wt.clamp(min=1e-30), 0.0)
    x0 = torch.from_numpy(r.random((H, W)) if warm else np.full((H, W), .5))
    z0 = torch.from_numpy(r.uniform(-1, 1, (f, H, W)) if warm
                          else np.zeros((f, H, W)))
    return shifts, (wt, c, tau, sigma, x0, z0,
                    torch.tensor(-float("inf"), dtype=torch.float64))


def run_chunks(step, certify, x0, tol, it_max, check_every):
    """The certified loop around ``step(st)`` (one PDHG step from state
    number st) and ``certify(st)``, as the kernel runs it."""
    gap = torch.tensor(float("inf"), dtype=x0.dtype)
    t_best = mf.thresholds(x0.dtype, x0.device)[0]
    it = st = 0
    while it < it_max and bool(gap > tol):
        for _ in range(check_every):
            step(st)
            st += 1
        gap, t_best = certify(st)
        it += check_every
    return gap, t_best, torch.tensor(it, dtype=torch.int32)


def stream_mirror(w, c, tau, sigma, x0, z0, tol, it_max, *, shifts,
                  check_every):
    """Schedule "stream": each cell's own edges and its in-edges (f, c - s_f)
    updated from the old state (buffer p), the new state written to
    buffer 1 - p."""
    sw = [sigma[k] * w[k] for k in range(len(shifts))]
    x = x0.clone()
    xb = [x0.clone(), torch.empty_like(x0)]
    z = [z0.clone(), torch.empty_like(z0)]

    def step(st):
        nonlocal x
        p = st & 1
        xb_r, z_r = xb[p], z[p]
        acc = torch.zeros_like(x)
        for k, (dy, dx) in enumerate(shifts):
            zo = torch.clamp(z_r[k] + sw[k] * (xb_r - _roll2(xb_r, -dy, -dx)),
                             -1, 1)
            # the in-edge, owned by the tail c - s_f, from the tail's values
            zi = torch.clamp(_roll2(z_r[k], dy, dx) + _roll2(sw[k], dy, dx)
                             * (_roll2(xb_r, dy, dx) - xb_r), -1, 1)
            acc = acc + w[k] * zo - _roll2(w[k], dy, dx) * zi
            z[1 - p][k] = zo
        x_new = torch.clamp(x - tau * (acc + c), 0, 1)
        xb[1 - p] = 2 * x_new - x
        x = x_new

    def certify(st):
        return mf.certificate_plain(w, c, x, z[st & 1], shifts=shifts)

    gap, t_best, it = run_chunks(step, certify, x0, tol, it_max, check_every)
    return x, z[int(it) & 1], gap, t_best, it


def band_mirror(w, c, tau, sigma, x0, z0, tol, it_max, *, shifts,
                check_every, bands):
    """Schedule "shared": rows in ``bands`` bands; each band updates the
    duals of its rows' edges and of its halo rows' edges (rows within hd of
    it, circularly) whose head lies in it, then the primal step on its
    rows, from copies of the previous step's state."""
    h, wd = x0.shape
    hd = max(abs(dy) for dy, _ in shifts)
    assert all(b * h // bands - (b - 1) * h // bands >= hd
               for b in range(1, bands + 1))
    sw = sigma * w
    x, xb, z = x0.clone(), x0.clone(), z0.clone()

    def step(st):
        nonlocal x, xb, z
        x_n, xb_n, z_n = (torch.empty_like(a) for a in (x, xb, z))
        for b in range(bands):
            r0, r1 = b * h // bands, (b + 1) * h // bands
            nr = r1 - r0
            rows = torch.arange(r0 - hd, r1 + hd) % h
            xb_e, z_e = xb[rows], z[:, rows]
            sw_e, w_e = sw[:, rows], w[:, rows]
            eb = len(rows)
            z_d = torch.full_like(z_e, float("nan"))  # not computed
            for k, (dy, dx) in enumerate(shifts):
                for lr in range(eb):
                    hr = lr + dy
                    own_l = hd <= lr < hd + nr
                    if not (own_l or hd <= hr < hd + nr):
                        continue
                    head = torch.roll(xb_e[hr], -dx)
                    z_d[k, lr] = torch.clamp(
                        z_e[k, lr] + sw_e[k, lr] * (xb_e[lr] - head), -1, 1)
            acc = torch.zeros((nr, wd), dtype=x.dtype)
            for k, (dy, dx) in enumerate(shifts):
                wz = w_e[k] * z_d[k]
                acc = (acc + wz[hd:hd + nr]
                       - torch.roll(wz, dx, dims=1)[hd - dy:hd - dy + nr])
            xn = torch.clamp(x[r0:r1] - tau[r0:r1] * (acc + c[r0:r1]), 0, 1)
            xb_n[r0:r1] = 2 * xn - x[r0:r1]
            x_n[r0:r1] = xn
            z_n[:, r0:r1] = z_d[:, hd:hd + nr]
        x, xb, z = x_n, xb_n, z_n

    def certify(st):
        return mf.certificate_plain(w, c, x, z, shifts=shifts)

    gap, t_best, it = run_chunks(step, certify, x0, tol, it_max, check_every)
    return x, z, gap, t_best, it


def assert_equal_runs(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("f", [2, 4])
def test_stream_schedule_equals_plain(f, warm):
    shifts, args = cut_inputs(f, warm, seed=f)
    kw = dict(shifts=shifts, check_every=CHECK)
    want = mf.pdhg_min_cut_plain(*args, STEPS, **kw)
    assert int(want[4]) == 750
    assert_equal_runs(stream_mirror(*args, STEPS, **kw), want)


@pytest.mark.parametrize("bands", [1, 5, "most"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("f", [2, 4])
def test_band_schedule_equals_plain(f, warm, bands):
    shifts, args = cut_inputs(f, warm, seed=10 + f)
    hd = max(abs(dy) for dy, _ in shifts)
    if bands == "most":  # bands of hd rows or a little more, the most
        bands = H // hd  # choose_schedule gives (W a multiple of 4)
    kw = dict(shifts=shifts, check_every=CHECK)
    want = mf.pdhg_min_cut_plain(*args, STEPS, **kw)
    assert_equal_runs(band_mirror(*args, STEPS, bands=bands, **kw), want)


H100 = dict(sm_count=132, smem_per_block=232_448)   # 227 KB opt-in
F2 = ((0, 1), (1, 0))


@pytest.mark.parametrize("side,shifts,dtype,want", [
    (140, F2, torch.float32, ("shared", 132)),   # EEG grid
    (512, F2, torch.float32, ("shared", 132)),   # multi-label CP
    (724, F2, torch.float32, ("shared", 132)),   # 524k denoising CP
    (140, F2, torch.float64, ("stream", 0)),
    (724, F2, torch.float64, ("stream", 0)),
    (724, SHIFTS[4], torch.float32, ("stream", 0)),   # F = 4, hd = 2
    (512, SHIFTS[4], torch.float32, ("stream", 0)),
    (96, SHIFTS[4], torch.float32, ("shared", 48)),   # bands of hd rows
    (1024, F2, torch.float32, ("stream", 0)),
    (141, F2, torch.float32, ("stream", 0)),          # 141 columns
    ((264, 1028), ((2, 0),), torch.float32, ("shared", 132)),
    (8, ((3, 0),), torch.float32, ("shared", 2)),
    (64, F2 + SHIFTS[4][2:] + ((2, 1),), torch.float32, ("stream", 0)),
    (2, ((3, 0),), torch.float32, ("stream", 0)),     # hd beyond the field
])
def test_schedule_choice(side, shifts, dtype, want):
    h, w = side if isinstance(side, tuple) else (side, side)
    assert mf.choose_schedule(h, w, shifts, dtype, **H100) == want


def test_schedule_fits_the_bytes_it_counts():
    """At 724 x 724, F = 2 the largest band (6 rows and two halo rows) is
    the one the shared memory must hold; one row more would not fit."""
    need = mf.band_bytes(724, 2, 1, 6)
    assert need <= H100["smem_per_block"] < mf.band_bytes(724, 2, 1, 7)
    assert mf.choose_schedule(724, 724, F2, torch.float32, 132, need - 1) \
        == ("stream", 0)
    assert mf.choose_schedule(724, 724, F2, torch.float32, 132, need) \
        == ("shared", 132)
