"""The devices the in-wheel cases run on."""


def devices():
    """``["cpu"]``, and ``"cuda"`` after it where PyTorch sees a card.

    Called inside each test, never at import, so that every process that
    collects the suite collects the same tests.
    """
    import torch

    return ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
