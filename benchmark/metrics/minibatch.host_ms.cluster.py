"""minibatch.host_ms.cluster (ms): host time a graph inside the ClusterGCN
sampler call (partition, induced subgraphs, ``build_graph`` and the
pieces' tensors), from the benchmark's span around the sampler it hands to
``_epoch_pass``."""


def read(view):
    spans = view.spans.get("sampler")
    return 1e3 * sum(spans) / len(spans) if spans else None
