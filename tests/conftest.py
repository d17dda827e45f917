"""Test-session config: keep JAX on the single host device (the 512-device
forcing is ONLY for the dry-run entry points), relax hypothesis deadlines on
loaded CI machines.  hypothesis is optional — property tests skip without it
(see _hyp.py)."""
import os

# Guard: tests must see exactly one device — dryrun/costmodel set XLA_FLAGS
# themselves and run as separate processes.
os.environ.pop("XLA_FLAGS", None)

try:
    from hypothesis import settings
except ModuleNotFoundError:
    settings = None

if settings is not None:
    settings.register_profile("repro", deadline=None, derandomize=True)
    settings.load_profile("repro")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-process fault-injection tests (subprocess "
        "JAX compiles); deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (hand-written kernels); skips "
        "without one")
