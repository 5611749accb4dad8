"""The committed JAX answers that the port's tests read (tests/jax_answers.py):
every file is the one its manifest names, and one answer, computed live
with the JAX package, still equals its file within the tolerance its tests
apply. A jax upgrade that moves the package's output fails here; `python
tests/jax_answers.py check` then names every answer that moved."""

import os

import jax_answers

MAX_BYTES = 600_000  # the whole store
# The cheapest answer that is a compiled JAX program with float outputs
# (camera rays and a march: ~3.3 s alone on 8 cores); the cheaper ones
# return integers from calls made op by op, which a moved contraction
# would not show in.
LIVE = "reflect-fast-march-default"


def test_jax_answers_match_manifest():
    manifest = jax_answers._manifest()
    assert sorted(manifest) == sorted(jax_answers.ANSWERS)
    files = sorted(os.listdir(jax_answers.DIR))
    assert files == sorted(["manifest.json"] + [f"{name}.npz" for name in manifest])
    for name, entry in manifest.items():
        path = os.path.join(jax_answers.DIR, f"{name}.npz")
        assert jax_answers.sha256(path) == entry["sha256"], name
    assert sum(os.path.getsize(os.path.join(jax_answers.DIR, f)) for f in files) < MAX_BYTES


def test_jax_answer_still_jax():
    key, arrays = jax_answers.ANSWERS[LIVE][0]()
    diffs = jax_answers.differences(LIVE, arrays, jax_answers.load(LIVE, key))
    assert all(d <= tol for d, tol in diffs.values()), diffs
