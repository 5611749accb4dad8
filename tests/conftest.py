"""Test configuration: force the CPU backend with 8 virtual devices so
sharding tests run without TPU hardware (SURVEY.md §4 multi-chip strategy).

Note: the hosted TPU plugin ignores the JAX_PLATFORMS env var, so the
programmatic `jax.config.update` is the one that actually takes effect.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# NO persistent XLA compilation cache. It was tried for suite speed
# (round 5) and REMOVED: XLA:CPU AOT results embed the build host's
# machine features (e.g. +prefer-no-gather), and loading them on a
# different host changes FMA contraction enough to fail rtol=1e-5
# invariants between a cached program and a freshly-compiled one
# (test_compact_secondary_matches caught it; the loader warns
# "machine type ... doesn't match"). Correctness over warm starts.


# --- distributed-test disposition logging (VERDICT r4 item 10) -----------
# test_distributed.py has broad, legitimate skip conditions (no sockets,
# runtime without distributed support, coordinator timeouts); a skipped run
# must not look identical to coverage. Record ran-vs-skipped (+ reason) in
# the terminal summary and in tests/.distributed_disposition.json so CI
# output shows whether multi-host init was actually exercised.

# --- periodic jax cache clearing (XLA:CPU segfault mitigation) -----------
# A full-suite run consistently SEGFAULTS inside XLA:CPU's
# backend_compile_and_load after ~100 tests of accumulated compiled
# executables (jax 0.9.0; the same compile succeeds in a fresh process,
# and a 47-test subset passes — the crash needs the full accumulated
# state). Dropping the Python-side references every N tests lets the
# backend release executables and keeps the compiler off the crashing
# path. Scoped per-test-count, not per-test: clearing is cheap but
# recompiles aren't, and module-scoped fixtures amortize compiles within
# a file.
_CLEAR_EVERY = 25
_test_counter = [0]


def pytest_runtest_teardown(item):
    _test_counter[0] += 1
    if _test_counter[0] % _CLEAR_EVERY == 0:
        import jax

        jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (skips inside the test without one)",
    )


_DIST_REPORTS = {}


def pytest_runtest_logreport(report):
    if "test_distributed.py" not in report.nodeid:
        return
    if report.when == "call" or (report.when == "setup" and report.skipped):
        reason = ""
        if report.skipped and isinstance(report.longrepr, tuple):
            reason = report.longrepr[2]
        _DIST_REPORTS[report.nodeid] = (report.outcome, reason)


def pytest_terminal_summary(terminalreporter):
    if not _DIST_REPORTS:
        return
    import json

    terminalreporter.section("distributed-test disposition")
    for nodeid, (outcome, reason) in sorted(_DIST_REPORTS.items()):
        line = f"{nodeid}: {outcome.upper()}"
        if reason:
            line += f" — {reason}"
        terminalreporter.write_line(line)
    path = os.path.join(os.path.dirname(__file__),
                        ".distributed_disposition.json")
    with open(path, "w") as f:
        json.dump(
            {n: {"outcome": o, "reason": r}
             for n, (o, r) in _DIST_REPORTS.items()},
            f, indent=1,
        )
