"""pytest settings of the benchmark's own tests (`pytest portbench`)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "card: needs an NVIDIA card (CUDA); skips, with its reason, where "
        "torch sees none")
