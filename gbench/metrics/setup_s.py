"""setup_s: seconds from the start of the process to the first timed call
(imports, the graph made on the card, the program's graph and layout, the
kernel build or load, the warm-up call)."""


def read(rec: dict):
    return rec.get("setup_s")
