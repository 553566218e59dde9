"""Pytest settings of the repository's tests."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skipped without one, run on "
        "the card with `python -m pytest -m card "
        "tests/test_torch_flash_backward_card.py`")
