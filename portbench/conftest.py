"""Settings of the benchmark's own tests: the marker for tests that need
a CUDA device, and the fixture that decides, inside a test, whether one
is there."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips with a reason without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card); none is available")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def cell_roots(tmp_path_factory):
    """The checkout a test runs each cell from: the repository for the
    measured cells, a copy with the EPaxos cell's entries for that one."""
    from portbench import spec
    from portbench.tests import tiny
    epaxos = tiny.root_with_epaxos(tmp_path_factory.mktemp("epaxos"))
    return {"pig25.montecarlo": spec.ROOT, "epaxos25.montecarlo": epaxos}
