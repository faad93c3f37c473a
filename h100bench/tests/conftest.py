import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(scope="session")
def has_card():
    import torch

    return torch.cuda.is_available()


@pytest.fixture()
def card(has_card):
    """Tests marked ``cuda`` take this: they skip where there is no card."""
    if not has_card:
        pytest.skip("needs an NVIDIA GPU; run on the card: "
                    "python -m pytest h100bench/tests -m cuda")
    return "cuda"
