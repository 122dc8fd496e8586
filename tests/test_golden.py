"""Golden full-pipeline regression test: the JAX exact-parity pipeline must
reproduce the committed fixture produced by the INDEPENDENT NumPy pipeline
(tests/golden_np.py, generated by scripts/make_golden.py) — integrate ->
dense trilinear march -> secant -> blendColors -> window depth ->
pull-push, composed end to end. The closest available stand-in for
recorded reference sequences (SURVEY.md §4). The tolerances live with the
fixture's generator (scripts/make_golden.py), which chip_smoke.py also
uses to run the same comparison on the GPU."""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import make_golden  # noqa: E402


@pytest.fixture(scope="module")
def golden():
    if not os.path.exists(make_golden.FIXTURE):
        pytest.skip("run scripts/make_golden.py to generate the fixture")
    return np.load(make_golden.FIXTURE)


@pytest.fixture(scope="module")
def jax_run():
    pipe, frames, _, _ = make_golden.build_scene()
    return make_golden.run_jax(pipe, frames)


def test_preprocessed_maps_match_fixture(golden, jax_run):
    make_golden.check_maps(golden, jax_run[0])


def test_volume_matches_numpy_pipeline(golden, jax_run):
    make_golden.check_volume(golden, jax_run[1])


def test_render_matches_numpy_pipeline(golden, jax_run):
    make_golden.check_render(golden, jax_run[2])
