"""Test harness config.

Multi-device correctness tests (shard_map collectives, TP-vs-phantom
equivalence, elastic checkpointing) need a small local mesh, so we ask the
CPU backend for 8 virtual devices — the standard JAX testing pattern.
NOTE: this is deliberately NOT the dry-run's 512 (launch/dryrun.py sets
that itself, in its own process, before importing jax).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=8 " + flags)

import jax  # noqa: E402  (must import after the flag)
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def mesh24():
    """(data=2, model=4) mesh."""
    from repro.launch.mesh import make_local_mesh
    return make_local_mesh(2, 4)


@pytest.fixture(scope="session")
def mesh18():
    """(data=1, model=8) mesh."""
    from repro.launch.mesh import make_local_mesh
    return make_local_mesh(1, 8)


@pytest.fixture(scope="session")
def mesh42():
    """(data=4, model=2) mesh."""
    from repro.launch.mesh import make_local_mesh
    return make_local_mesh(4, 2)


@pytest.fixture(scope="session")
def mesh14():
    """(data=1, model=4) mesh — same tp as mesh24, half the dp (elastic
    rescale changes dp only: the phantom model class is tp-dependent)."""
    from repro.launch.mesh import make_local_mesh
    return make_local_mesh(1, 4)


@pytest.fixture(scope="session")
def mesh222():
    """(pipe=2, data=2, model=2) mesh — the pipeline-parallel testbed."""
    from repro.launch.mesh import make_local_mesh
    return make_local_mesh(2, 2, 2)


@pytest.fixture(scope="session")
def mesh124():
    """(pipe=4, data=1, model=2) mesh — deep-pipeline testbed."""
    from repro.launch.mesh import make_local_mesh
    return make_local_mesh(1, 2, 4)


@pytest.fixture(scope="session")
def mesh12():
    """(data=1, model=2) mesh — the pp-mesh equivalence reference."""
    from repro.launch.mesh import make_local_mesh
    return make_local_mesh(1, 2)


@pytest.fixture(scope="session")
def compiled_step_cache():
    """Session-scoped memo of jit-compiled step/probe builders.

    Compiling a shard_map step dominates test wall time, and the
    property-based suites re-draw the same few configurations many
    times; ``cache.build(maker, cfg, mesh, *key_extras)`` calls
    ``maker(cfg, mesh, *key_extras)`` once per distinct (maker, cfg,
    mesh axes, extras) and replays the compiled result afterwards.
    ``ModelConfig`` is frozen/hashable, so the config IS the key.
    """
    class _Cache(dict):
        def build(self, maker, cfg, mesh, *extras):
            key = (maker.__module__, maker.__qualname__, cfg,
                   tuple(zip(mesh.axis_names, mesh.devices.shape)), extras)
            if key not in self:
                self[key] = maker(cfg, mesh, *extras)
            return self[key]

    return _Cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); "
                   "skips on a machine without one")
