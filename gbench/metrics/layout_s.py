"""layout_s: host seconds of the program's ``build_blocked`` (the pull
layout), ending in a synchronise."""


def read(rec: dict):
    return rec["setup"].get("layout_s")
