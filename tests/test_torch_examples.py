"""The port's examples (``examples/torch_example_*.py``) against the JAX
package's (``examples/example_*.py``).

The port's examples keep their own copies of the problem generators; here
they must give arrays equal to the JAX examples' on the same seeds.  The
``slow`` tests run each port example on the CPU and hold it to the quality
bars of ``tests/test_examples.py``; the distributed one runs its four paths
in two gloo ranks and asserts its own bars.
"""
import numpy as np
import pytest
import torch

import examples.example_EEG_CP as jax_eeg
import examples.example_labeling_CP as jax_labeling
import examples.torch_example_distributed as torch_distributed
import examples.torch_example_EEG_CP as torch_eeg
import examples.torch_example_labeling_CP as torch_labeling


def test_eeg_sphere_mesh_matches_jax_example():
    for got, want in zip(torch_eeg.make_sphere_mesh(),
                         jax_eeg.make_sphere_mesh()):
        np.testing.assert_array_equal(got, want)


def test_eeg_problem_matches_jax_example():
    for got, want in zip(torch_eeg.make_problem(seed=0),
                         jax_eeg.make_problem(seed=0)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_eeg_dice_scores_match_jax_example(seed):
    """Raw and 2-means-cleaned Dice scores on fixed sparse fields."""
    r = np.random.default_rng(seed)
    x0 = np.where(r.random(500) < 0.1, r.uniform(1, 3, 500), 0.0)
    x = np.where(r.random(500) < 0.2, r.exponential(1.0, 500), 0.0)
    assert torch_eeg.dice_scores(x, x0) == jax_eeg.dice_scores(x, x0)


def test_eeg_stencil_is_the_sphere_mesh():
    """The example's three-family stencil holds the sphere mesh's edges
    (the wrapped azimuthal seam included), and no others."""
    g = torch_eeg.make_stencil_graph(0.5, "cpu", torch.float64)
    eu, ev, la = g.host_coo()
    live = la > 0
    got = {tuple(sorted(e)) for e in zip(eu[live], ev[live])}
    _, meu, mev = torch_eeg.make_sphere_mesh()
    assert got == {tuple(sorted(e)) for e in zip(meu, mev)}
    assert len(got) == live.sum() == len(meu)


def test_labeling_problem_matches_jax_example():
    for got, want in zip(torch_labeling.make_problem(),
                         jax_labeling.make_problem()):
        np.testing.assert_array_equal(got, want)


def test_distributed_problem_is_the_jax_examples():
    """``make_problem`` draws the JAX example's arrays: the operator and
    observation, then the denoising image from the same generator."""
    pb = torch_distributed.make_problem()
    r = np.random.default_rng(0)
    a = (r.standard_normal((64, 1024)) / np.sqrt(64)).astype(np.float32)
    x_true = np.zeros((32, 32), np.float32)
    x_true[8:16, 8:16] = 1.5
    y = (a @ x_true.ravel() + 0.02 * r.standard_normal(64)).astype(
        np.float32)
    y_img = (x_true + 0.1 * r.standard_normal((32, 32))).astype(
        np.float32).ravel()
    for key, want in (("a", a), ("y", y), ("x_true", x_true),
                      ("y_img", y_img)):
        np.testing.assert_array_equal(pb[key], want)
    assert pb["eu"].shape == pb["ev"].shape == (2 * 32 * 31,)


@pytest.mark.slow
def test_torch_eeg_example_recovers_support():
    ds, dsa = torch_eeg.main(device="cpu")
    # the bars of tests/test_examples.py::test_eeg_example_recovers_support
    assert dsa >= 0.6
    assert ds >= 0.4


@pytest.mark.slow
def test_torch_labeling_example_denoises():
    acc_in, acc_out = torch_labeling.main(device="cpu")
    assert acc_out >= acc_in + 0.2
    assert acc_out >= 0.85


@pytest.mark.slow
def test_torch_distributed_example_agrees():
    # two gloo ranks; the example asserts its four paths' bars itself
    out = torch_distributed.main(ranks=2, device="cpu")
    assert out["ranks"] == 2
