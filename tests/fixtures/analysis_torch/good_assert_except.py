"""Known-good: guard hygiene."""


def tile(m, bm):
    if m % bm:
        raise ValueError(f"{m} is not a multiple of {bm}")
    return m // bm


def load(path):
    try:
        return open(path).read()
    except FileNotFoundError:
        return None
