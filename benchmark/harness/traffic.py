"""The one generator that reads every traffic mix (``benchmark/traffic/<mix>.json``).

A mix is data: its ``kind`` names the kind of instance and the rest are that
kind's parameters.  Every seed gets the same work in another order: the
mix's ``pool`` of instance shapes (clean images, source amplitudes) comes
from its ``pool_seed``, and each seed walks the pool in cycles, every cycle
in an order of its own drawn from ``(seed, 3, cycle)``; the noise of every
solve is its own, from ``(seed, 0, i)`` for window solve ``i`` and
``(seed, 1, k)`` for warm-up solve ``k``.  So the same seed gives the same
inputs, no two solves share one, and runs of different seeds solve nearly
the same shapes (the per-image work varies by a quarter, which would
otherwise move a run's mean by a few percent from seed to seed).  A mix
also names the warm-up solves and the traced slice (``warmup_solves``,
``trace_first``, ``trace_solves``): one whole cycle from solve 0 profiles
the same shapes for every seed.  Kinds:

* ``"cartoon"``: an image of ``side`` x ``side`` pixels with ``rects``
  constant rectangles (corner in ``[margin_lo, side - margin_hi)``, sides in
  ``rect_size``, values in ``value``), plus Gaussian noise of standard
  deviation ``noise_sigma`` (``bench.py:366-386``'s 524k denoising image).
  The rectangles are numbers on the host, the noise and the image are
  drawn on the solve's device.
* ``"eeg"``: one time sample of an EEG recording on the configuration's
  sphere (``examples/torch_example_EEG_CP.make_problem``, copied here):
  ``n_sources`` patches of radius ``source_radius`` whose centres come, with
  the electrodes, from ``pool_seed`` (the example's own draw for 0), the
  patches' amplitudes (uniform in ``amplitude``) from the pool, and the
  sensor noise (``noise`` of the signal's RMS) from the solve.
"""
from __future__ import annotations

import numpy as np
import torch

WINDOW, WARMUP, CHECK, ORDER = 0, 1, 2, 3


def rng(seed: int, *index: int) -> np.random.Generator:
    """The generator of one instance: ``seed`` (any whole number) and the
    instance's index, through numpy's ``SeedSequence``."""
    return np.random.default_rng([int(seed) % 2**64, *map(int, index)])


def pool_index(seed: int, pool: int, stream: int, i: int) -> int:
    """The pool entry of solve ``i`` of a stream: the seed's order of its
    cycle ``i // pool``, position ``i % pool`` (warm-up solves take the
    entries in turn)."""
    if stream != WINDOW:
        return i % pool
    return int(rng(seed, ORDER, i // pool).permutation(pool)[i % pool])


def device_generator(r: np.random.Generator, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(r.integers(2**63)))
    return g


class Cartoon:
    """``"cartoon"`` instances: flat [side * side] observations."""

    def __init__(self, mix: dict, seed: int, device, dtype):
        self.side = int(mix["side"])
        self.rects = int(mix["rects"])
        self.rect_size = tuple(int(v) for v in mix["rect_size"])
        self.value = tuple(float(v) for v in mix["value"])
        self.margin = (int(mix["margin_lo"]), int(mix["margin_hi"]))
        self.sigma = float(mix["noise_sigma"])
        self.pool = [self._rects(rng(int(mix["pool_seed"]), k))
                     for k in range(int(mix["pool"]))]
        self.seed, self.device, self.dtype = seed, device, dtype

    def _rects(self, r):
        out = []
        for _ in range(self.rects):
            i, j = r.integers(self.margin[0], self.side - self.margin[1], 2)
            h, w = r.integers(*self.rect_size, 2)
            out.append((int(i), int(j), int(h), int(w),
                        float(r.uniform(*self.value))))
        return out

    def draw(self, stream: int, i: int) -> torch.Tensor:
        side = self.side
        img = torch.zeros((side, side), dtype=self.dtype, device=self.device)
        for a, b, h, w, v in self.pool[pool_index(self.seed, len(self.pool),
                                                  stream, i)]:
            img[a:a + h, b:b + w] = v
        noise = torch.randn((side, side), dtype=self.dtype, device=self.device,
                            generator=device_generator(
                                rng(self.seed, stream, i), self.device))
        return (img + self.sigma * noise).reshape(-1)


def sphere_mesh(n_theta: int, n_phi: int, margin: float):
    """Vertices [V, 3] of the theta-phi grid on the unit sphere (the cortex
    stand-in of the EEG example), row-major over (theta, phi)."""
    thetas = np.linspace(margin, np.pi - margin, n_theta)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(thetas, phis, indexing="ij")
    return np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                     np.cos(tt)], axis=-1).reshape(-1, 3)


class EEG:
    """``"eeg"`` instances: ``(y [N] float32, index)``; ``phi`` [N, V]
    float32 and the source patches are fixed for the run."""

    def __init__(self, config: dict, mix: dict, seed: int):
        m = config["mesh"]
        verts = sphere_mesh(int(m["n_theta"]), int(m["n_phi"]),
                            float(m["theta_margin"]))
        num_v = len(verts)
        g = np.random.default_rng(int(mix["pool_seed"]))
        # the example's draws, in its order: electrodes, then per source a
        # centre and an amplitude (discarded: the amplitudes are the pool's)
        elec = verts[g.choice(num_v, int(config["n_electrodes"]),
                              replace=False)] * float(config["electrode_radius"])
        d = np.linalg.norm(elec[:, None, :] - verts[None, :, :], axis=-1)
        phi = 1.0 / d ** float(config["leadfield_power"])
        phi /= np.linalg.norm(phi, axis=1, keepdims=True)
        self.phi64 = phi
        self.phi = phi.astype(np.float32)
        self.patches = []
        for _ in range(int(mix["n_sources"])):
            centre = g.integers(0, num_v)
            g.uniform(*mix["amplitude"])
            dist = np.linalg.norm(verts - verts[centre], axis=1)
            self.patches.append(dist < float(mix["source_radius"]))
        amp = tuple(float(v) for v in mix["amplitude"])
        self.pool = [rng(int(mix["pool_seed"]), k).uniform(
            *amp, len(self.patches)) for k in range(int(mix["pool"]))]
        self.noise = float(mix["noise"])
        self.seed = seed
        self.num_v = num_v

    def draw(self, stream: int, i: int) -> np.ndarray:
        amps = self.pool[pool_index(self.seed, len(self.pool), stream, i)]
        r = rng(self.seed, stream, i)
        x0 = np.zeros(self.num_v)
        for patch, a in zip(self.patches, amps):
            x0[patch] = a
        y = self.phi64 @ x0
        n_obs = len(y)
        y = y + self.noise * np.linalg.norm(y) / np.sqrt(n_obs) * \
            r.standard_normal(n_obs)
        return y.astype(np.float32)


def lambda_of(phi32: np.ndarray, y0_32: np.ndarray, scale: float) -> float:
    """The example's SURE-like penalty ``scale * mean |phi^t y0|``, in
    float64 from the float32 inputs both sides are handed."""
    return float(scale * np.abs(phi32.astype(np.float64).T
                                @ y0_32.astype(np.float64)).mean())
