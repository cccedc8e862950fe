"""decode.s.assemble (s): host time a graph inside ``get_contigs``."""


def read(view):
    spans = view.spans.get("decode")
    return sum(spans) / len(spans) if spans else None
