"""score.ms.assemble (ms): host time a graph of ``score_graph`` through
``extract_edge_values`` (which waits for the device)."""


def read(view):
    spans = view.spans.get("score")
    return 1e3 * sum(spans) / len(spans) if spans else None
