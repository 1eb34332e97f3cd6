"""Known-bad: guard hygiene."""


def tile(m, bm):
    assert m % bm == 0
    return m // bm


def load(path):
    try:
        return open(path).read()
    except Exception:
        pass
