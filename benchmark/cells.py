"""The two kinds of cell the traffic files name (``"mode"``), each driving
the program through its own entry points:

* ``train``: ``gnnome_tpu_torch/train/loop.py`` ``_epoch_pass``, the
  function ``train()`` runs each epoch, one graph a call: one optimizer step
  a graph (full-graph regime), or the ClusterGCN pieces that
  ``make_cluster_fns(cfg)``'s sampler cuts from it, one step each;
* ``assemble``: what ``decode/inference.py`` ``inference()`` does for each
  graph: ``score_graph``, ``extract_edge_values``, then ``greedy.get_contigs``
  with the program's default engine and the default ``DecodeConfig``.

A cell builds its inputs and weights from the seed (``setup``), runs units
(a graph each) for the window, and afterwards hands what the program
produced to the reference model its configuration names (``reference``,
``benchmark/reference/__init__.py`` ``load``) and to
``benchmark/reference/compare.py`` (``numbers``).
"""
from __future__ import annotations

import gc
import random
import re
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import reference
from benchmark.reference import compare
from benchmark.reference import decode as ref_decode
from benchmark.trace import Recorder, graph_dims
from benchmark.traffic import graphs

ROOT = Path(__file__).resolve().parent.parent


def flat_name(path: str) -> str:
    """``['layers'][3]['A1']['w']`` -> ``layers.3.A1.w``."""
    return ".".join(re.findall(r"\['?([^'\]]+)'?\]", path))


def nest(flat: dict) -> dict:
    """Flat ``{layers.3.A1.w: tensor}`` -> the program's parameter tree
    (copies: the program updates its leaves in place)."""
    tree: dict = {"layers": []}
    for name, leaf in flat.items():
        parts = name.split(".")
        node = tree
        if parts[0] == "layers":
            i = int(parts[1])
            while len(tree["layers"]) <= i:
                tree["layers"].append({})
            node, parts = tree["layers"][i], parts[2:]
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf.detach().clone()
    return tree


def program_config(config: dict, traffic: dict):
    from gnnome_tpu_torch.config import Config, ModelConfig

    cfg = Config()
    cfg.model = ModelConfig(**{k: config[k] for k in ModelConfig.__dataclass_fields__
                               if k in config})
    cfg.train.compute_dtype = config["compute_dtype"]
    for key, value in traffic.get("train", {}).items():
        setattr(cfg.train, key, value)
    return cfg


def host_graph_tensors(host: dict, device, node_ids=None, edge_ids=None) -> dict:
    """The reference's view of a graph: int64 endpoints and f32 features in
    edge-list order, optionally the subgraph induced by ``node_ids`` (whose
    edges ``edge_ids`` are), relabelled in ``node_ids``' order."""
    src, dst = np.asarray(host["src"], np.int64), np.asarray(host["dst"], np.int64)
    e_feat, pe, y = host["e_feat"], host["pe"], host.get("y")
    if node_ids is not None:
        relabel = -np.ones(host["n_nodes"], np.int64)
        relabel[node_ids] = np.arange(len(node_ids))
        src, dst = relabel[src[edge_ids]], relabel[dst[edge_ids]]
        e_feat, pe = e_feat[edge_ids], pe[node_ids]
        y = None if y is None else y[edge_ids]
    out = dict(src=torch.from_numpy(src).to(device), dst=torch.from_numpy(dst).to(device),
               e_feat=torch.from_numpy(np.ascontiguousarray(e_feat)).to(device),
               pe=torch.from_numpy(np.ascontiguousarray(pe)).to(device))
    if y is not None:
        out["y"] = torch.from_numpy(np.ascontiguousarray(y)).to(device)
    return out


def induced_edges(host: dict, nodes: np.ndarray) -> np.ndarray:
    """Ids of the edges whose both ends are among ``nodes``, ascending."""
    keep = np.zeros(host["n_nodes"], bool)
    keep[nodes] = True
    return np.nonzero(keep[host["src"]] & keep[host["dst"]])[0]


class Cell:
    """What both kinds share: inputs from the seed, the recorder, the
    configuration's reference model."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, recorder: Recorder):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.rec = torch.device(device), recorder
        self.reference = reference.load(config)
        self.batch_norm = config["batch_norm"]

    def host_graphs(self) -> list:
        return [graphs.make_graph(self.traffic, self.seed, g, self.config["nb_pos_enc"])
                for g in range(self.traffic["n_graphs"])]

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        for name in self.program_state:
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class FirstSteps:
    """Wraps ``loop.train_step`` while set-up runs: the loss of each of the
    first three steps, the first gradient as Adam got it, and the
    parameters after the third step."""

    def __init__(self, loop, names: list):
        self.loop, self.step, self.names = loop, loop.train_step, names
        self.losses, self.grad1, self.theta3 = [], None, None

    def __call__(self, params, opt, *args, **kw):
        out = self.step(params, opt, *args, **kw)
        if len(self.losses) < 3:
            self.losses.append(out[0].detach().clone())
            leaves = opt.param_groups[0]["params"]
            if len(self.losses) == 1:
                beta1 = opt.param_groups[0]["betas"][0]
                # no first moment kept: no gradient reached the optimizer
                self.grad1 = {n: opt.state[p].get("exp_avg", torch.zeros_like(p)).detach()
                              / (1.0 - beta1) for n, p in zip(self.names, leaves)}
            if len(self.losses) == 3:
                self.theta3 = {n: p.detach().clone() for n, p in zip(self.names, leaves)}
        return out

    def __enter__(self):
        self.loop.train_step = self
        return self

    def __exit__(self, *exc):
        self.loop.train_step = self.step

    def readings(self) -> dict:
        return dict(losses=[float(x) for x in self.losses], grad1=self.grad1,
                    theta3=self.theta3)


class StepLog:
    """Wraps ``loop.train_step`` in a traced window: a span a step and the
    graph each step ran on (the launches' sizes)."""

    def __init__(self, loop, rec: Recorder, dims: dict):
        self.loop, self.step, self.rec, self.dims = loop, loop.train_step, rec, dims

    def __call__(self, params, opt, graph, *args, **kw):
        g = self.dims.get(id(graph)) or graph_dims(graph)
        self.rec.graph = g
        self.rec.steps.append(g)
        with self.rec.span("step"):
            return self.step(params, opt, graph, *args, **kw)

    def __enter__(self):
        self.loop.train_step = self
        return self

    def __exit__(self, *exc):
        self.loop.train_step = self.step


class Sampler:
    """The ClusterGCN sampler handed to ``_epoch_pass``, inside a span. Of
    the first call it keeps each piece's host arrays, for the check; of
    every call the pieces' real edges."""

    def __init__(self, sampler, rec: Recorder):
        self.sampler, self.rec, self.first, self.edges = sampler, rec, None, []

    def __call__(self, sample):
        with self.rec.span("sampler"):
            pieces = self.sampler(sample)
        if self.first is None:
            self.first = [dict(idx=p.idx, nodes=np.asarray(p.read_length),
                               edge_ids=np.asarray(p.prefix_length), src=p.src, dst=p.dst,
                               n_nodes=p.graph.n_nodes, n_edges=p.graph.n_edges)
                          for p in pieces]
        self.edges.append([p.graph.n_edges for p in pieces])
        return pieces


class TrainCell(Cell):
    program_state = ("samples", "params", "opt")

    def setup(self) -> None:
        from gnnome_tpu_torch.core.graph import build_graph, pad_features, prepare_edge_features
        from gnnome_tpu_torch.data.dataset import GraphSample
        from gnnome_tpu_torch.train import checkpoint, loop

        self.loop = loop
        tr = self.traffic
        self.cfg = program_config(self.config, tr)
        self.host = self.host_graphs()
        self.samples, self.dims = [], {}
        for g, h in enumerate(self.host):
            graph = build_graph(h["src"], h["dst"], h["n_nodes"], device=self.device)
            e, n = len(h["src"]), h["n_nodes"]
            # the sampler slices the host arrays of a sample: read and prefix
            # lengths carry each piece's node and edge ids to the check
            self.samples.append((g, GraphSample(
                idx=g, graph=graph, e_feat=prepare_edge_features(graph, h["e_feat"]),
                pe=torch.from_numpy(pad_features(h["pe"], graph.n_nodes_padded)).to(self.device),
                y=prepare_edge_features(graph, h["y"]), prefix_length=np.arange(e),
                read_length=np.arange(n), overlap_length=np.zeros(e, np.int64),
                overlap_similarity=np.zeros(e, np.float32), src=h["src"], dst=h["dst"])))
            self.dims[id(graph)] = graph_dims(graph, h)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.theta0 = self.reference.init_params(gen, self.config, self.device)
        self.params = nest(self.theta0)
        self.opt = loop.make_optimizer(self.params, tr["lr"])
        self.names = [flat_name(p) for p, _ in checkpoint.iter_leaves(self.params)]
        self.pos_weight = torch.tensor(tr["pos_weight"], dtype=torch.float32,
                                       device=self.device)
        fn, _ = loop.make_cluster_fns(self.cfg)
        self.sampler_fn = None if fn is None else Sampler(fn, self.rec)
        self.next, self.order = graphs.first_graph(tr, self.seed), []
        with FirstSteps(loop, self.names) as first:
            for _ in range(tr["warmup_units"]):
                self.unit()
        self.first = first.readings()
        self.first_pieces = self.sampler_fn.first[:3] if self.sampler_fn else None

    def unit(self) -> tuple[int, int, int]:
        """One ``_epoch_pass`` over the next graph: (steps, failed steps,
        real edges of the steps)."""
        g, sample = self.samples[self.next % len(self.samples)]
        self.next += 1
        self.order.append(g)
        out = self.loop._epoch_pass([(g, sample)], self.params, self.opt, self.pos_weight,
                                    self.cfg, True, self.sampler_fn)
        if self.sampler_fn is None:
            steps, edges = 1, sample.graph.n_edges
        else:
            steps, edges = len(self.sampler_fn.edges[-1]), sum(self.sampler_fn.edges[-1])
        return steps, int(not np.isfinite(out["loss"])), edges

    def traced(self):
        return StepLog(self.loop, self.rec, self.dims)

    def reference_readings(self, bits=None) -> dict:
        """The reference's first three steps from the same weights, on the
        graphs (or the pieces' node sets) the program's steps took; with
        ``bits``, every product's operands rounded (the control)."""
        params = {k: v.clone() for k, v in self.theta0.items()}
        opt = self.reference.Adam(params, self.traffic["lr"])
        losses, grad1 = [], None
        for k in range(3):
            if self.first_pieces is None:
                graph = host_graph_tensors(self.host[self.order[k]], self.device)
            else:
                graph = self.piece_graph(self.first_pieces[k])
            loss, grads = self.reference.train_step(params, opt, graph,
                                                    self.traffic["pos_weight"], self.config,
                                                    bits)
            losses.append(loss)
            grad1 = grads if grad1 is None else grad1
            del graph, grads
        return dict(losses=losses, grad1=grad1, theta3=params)

    def piece_graph(self, piece: dict) -> dict:
        """The reference's own induced subgraph of a piece's node set."""
        h = self.host[piece["idx"]]
        return host_graph_tensors(h, self.device, piece["nodes"],
                                  induced_edges(h, piece["nodes"]))

    def piece_faults(self) -> int:
        """Pieces of the first sampler call that are not the subgraph
        induced by their node set (edge ids, relabelled endpoints, sizes),
        and nodes that its pieces do not cover exactly once."""
        pieces = self.sampler_fn.first
        h = self.host[pieces[0]["idx"]]
        seen = np.zeros(h["n_nodes"], np.int64)
        faults = 0
        for p in pieces:
            nodes, got = p["nodes"], p["edge_ids"]
            seen[nodes] += 1
            want = induced_edges(h, nodes)
            relabel = -np.ones(h["n_nodes"], np.int64)
            relabel[nodes] = np.arange(len(nodes))
            sound = (np.array_equal(np.sort(got), want)
                     and np.array_equal(relabel[h["src"][got]], p["src"])
                     and np.array_equal(relabel[h["dst"][got]], p["dst"])
                     and p["n_edges"] == len(want) and p["n_nodes"] == len(nodes))
            faults += int(not sound)
        return faults + int((seen != 1).sum())

    def numbers(self, readings: dict | None = None) -> dict:
        """The compared numbers: the program's first steps (or ``readings``
        put in the program's place) against the reference's."""
        if getattr(self, "ref", None) is None:
            self.ref = self.reference_readings()
        out = compare.training_numbers(readings or self.first, self.ref, self.theta0)
        if self.sampler_fn is not None:
            out["piece_faults"] = self.piece_faults()
        return out


class AssembleCell(Cell):
    program_state = ("samples", "params")

    def setup(self) -> None:
        from gnnome_tpu_torch.core.graph import build_graph, pad_features, prepare_edge_features
        from gnnome_tpu_torch.decode import greedy, inference

        self.greedy, self.inference = greedy, inference
        self.cfg = program_config(self.config, self.traffic)
        self.params = inference.load_model(str(ROOT / self.traffic["weights"]), self.cfg,
                                           self.device)
        self.host = self.host_graphs()
        self.samples = []
        for h in self.host:
            graph = build_graph(h["src"], h["dst"], h["n_nodes"], device=self.device)
            self.samples.append((graph, prepare_edge_features(graph, h["e_feat"]),
                                 torch.from_numpy(pad_features(h["pe"], graph.n_nodes_padded))
                                 .to(self.device)))
        for graph, e_feat, pe in self.samples:  # every graph's shapes
            self.inference.score_graph(self.params, graph, e_feat, pe,
                                       batch_norm=self.batch_norm)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.next, self.done = graphs.first_graph(self.traffic, self.seed), []

    def unit(self, decode: bool = True) -> tuple[int, int, int]:
        """One graph from features to contig walks: (1, failed, edges);
        without ``decode``, only its scores."""
        from gnnome_tpu_torch.core.graph import extract_edge_values

        g = self.next % len(self.samples)
        self.next += 1
        graph, e_feat, pe = self.samples[g]
        h = self.host[g]
        with self.rec.span("score"):
            logits = self.inference.score_graph(self.params, graph, e_feat, pe,
                                                batch_norm=self.batch_norm)
            scores = extract_edge_values(graph, logits).astype(np.float64)
        dc, walks = self.cfg.decode, None
        if decode:
            with self.rec.span("decode"):
                walks = self.greedy.get_contigs(
                    h["src"], h["dst"], scores, h["succs"], h["preds"], h["edges"],
                    h["prefix_length"], h["read_length"], nb_paths=dc.num_decoding_paths,
                    len_threshold=dc.len_threshold, seed=self.cfg.train.seed,
                    min_prob=dc.min_prob)
        self.done.append((g, scores, walks))
        return 1, int(not np.isfinite(scores).all()), graph.n_edges

    def traced(self):
        import contextlib

        return contextlib.nullcontext()

    def checked(self) -> tuple:
        """The graph of the window whose answers are checked, drawn from
        the seed."""
        return self.done[random.Random(self.seed).randrange(len(self.done))]

    def reference_logits(self, g: int, bits=None) -> torch.Tensor:
        with np.load(ROOT / self.traffic["weights"]) as z:
            params = {flat_name(k): torch.from_numpy(z[k]).to(self.device) for k in z.files}
        with torch.no_grad():
            return self.reference.forward(params, host_graph_tensors(self.host[g], self.device),
                                          self.config, bits, remat=False)

    def numbers(self, readings=None) -> dict:
        g, scores, walks = self.checked()
        if getattr(self, "ref", None) is None:
            self.ref = self.reference_logits(g)
        ref = self.ref
        got = torch.from_numpy(scores).to(ref.device) if readings is None else readings
        out = dict(logit_gap=compare.logit_gap(got, ref))
        if readings is None and walks is not None:
            h, dc = self.host[g], self.cfg.decode
            ref_walks = ref_decode.get_contigs(
                h["src"], h["dst"], scores, h["succs"], h["preds"], h["edges"],
                h["prefix_length"], h["read_length"], dc.num_decoding_paths,
                dc.len_threshold, self.cfg.train.seed)
            out["walks_differ"] = compare.walks_differ(walks, ref_walks)
        return out


KINDS = {"train": TrainCell, "assemble": AssembleCell}


def make(config: dict, traffic: dict, seed: int, device, recorder: Recorder) -> Cell:
    return KINDS[traffic["mode"]](config, traffic, seed, device, recorder)


def run_window(cell: Cell, seconds: float) -> dict:
    """Units until ``seconds`` have passed, ending at a unit's end (with
    ``whole_passes``, at the end of a pass over the graph set, so that every
    run does each graph as often): the window's length, the steps attempted
    and failed, and the real edges of the steps done."""
    steps = failed = edges = units = 0
    passes = cell.traffic["n_graphs"] if cell.traffic.get("whole_passes") else 1
    t0 = time.perf_counter()
    while True:
        s, f, e = cell.unit()
        steps, failed, edges, units = steps + s, failed + f, edges + e, units + 1
        if time.perf_counter() - t0 >= seconds and units % passes == 0:
            break
    return dict(window_s=time.perf_counter() - t0, steps=steps, failed=failed, edges=edges,
                units=units)
