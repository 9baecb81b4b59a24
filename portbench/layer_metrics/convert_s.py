"""Seconds of the program's format selection and conversion in set-up
(``convert/``: ``select.suggest_format`` and the ``coo_to_*`` converter),
from the benchmark's span around them."""


def read(rec: dict):
    return rec.get("convert_s")
