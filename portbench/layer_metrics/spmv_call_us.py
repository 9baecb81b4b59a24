"""Host microseconds of one call of the route's op (``ops/``: padding,
the kernel's launch, the epilogue), without a synchronise: what the host
pays to enqueue a product, over every call of the window outside the
traced slice."""


def read(rec: dict):
    return rec.get("call_us")
