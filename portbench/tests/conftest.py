"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
checkout's root (CPU); ``-m cuda`` runs the card's."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")
