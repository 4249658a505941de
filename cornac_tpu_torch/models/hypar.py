"""HypAR — Hypergraph with Attention on Reviews for explainable
recommendation (Jendal et al., ECIR 2024).

Port of ``cornac_tpu/models/hypar.py``: sentiment hypergraphs over user,
item, aspect and opinion nodes with a channel per sentiment, a 3-layer
normalised hypergraph convolution, NARRE or GATv2 review attention,
a LightGCN or MF preference module, seven combiners, dot or NARRE
predictors, an optional TransR or non-linear explainability loss, and a
ranking or rating objective, trained with AdamW on edge minibatches over
the full graph.

- The host builds (``_stem_maps``, ``_create_graphs``,
  ``_ao_content_embeddings``) are copies of the JAX package's. The stemmer
  is NLTK's Porter stemmer where NLTK imports and lower-casing where it
  does not, as in the JAX package: the vocabulary follows the machine.
  ``_ao_content_embeddings`` calls ``scipy.sparse.linalg.svds`` with no
  random state, as the JAX package does, so its vectors (and their signs)
  follow svds' random start: numpy's global state in older scipy, fresh
  entropy in scipy 1.17. ``fixed_svds_start`` pins that start, for
  reproducible fits of either package.
- ``HypARNet`` is the model as an ``nn.Module``: its parameters are the JAX
  package's, flattened (``hyper_W.0.p.w`` names ``params["hyper_W"][0]["p"]
  ["w"]``). Every scatter-add of the forward pass (the hypergraph
  convolution's, the attention's sums, LightGCN's) goes through
  ``scatter_rows`` / ``accumulate_rows`` and every gather whose gradient is
  a scatter through ``gather_rows``: the sums are taken in edge order, so a
  step gives the same bits on every run. The attention's segment max is
  ``scatter_reduce("amax")``, deterministic too.
- ``hypar_draws`` makes an epoch's draws (the permutation, then each step's
  dropout masks, negatives and explainability negatives, in the JAX
  package's order) from one ``torch.Generator``; ``loss_on`` takes a step's
  draws, so the tests feed it the JAX key's own.
"""

import contextlib
import re

import numpy as np
import scipy.sparse as sp
import torch

from ..exception import ScoreException
from ..ops.accumulate import gather_rows
from ..ops.graph import NormAdjacency, scatter_rows
from ..ops.optim import adamw, step as optim_step
from ..utils import get_rng
from .recommender import Recommender, pad_to_catalog
from .review_utils import flatten

COMBINERS = (
    "add", "mul", "bi-interaction", "concat", "review-only", "self", "self-only"
)


def _stem_fn(x):
    try:
        from nltk.stem import PorterStemmer

        stemmer = PorterStemmer()
        cleaned = re.sub(r"--+.*|-+$|\+\+|'.+|=+.*$|-\d.*", "", x)
        return stemmer.stem(cleaned.lower())
    except Exception:  # nltk missing
        return x.lower()


def stemmer_name():
    """Which stemmer ``_stem_fn`` runs here: "nltk porter" or "lowercase"."""
    try:
        from nltk.stem import PorterStemmer  # noqa: F401

        return "nltk porter"
    except Exception:
        return "lowercase"


@contextlib.contextmanager
def fixed_svds_start(seed=0):
    """While open, ``scipy.sparse.linalg.svds`` called without a starting
    vector starts from one drawn from ``RandomState(seed)``, the same on
    every call and every scipy version: the content vectors of HypAR's fit
    (either package's) are then the same on every run."""
    import scipy.sparse.linalg as spla

    real = spla.svds

    def svds(A, k=6, *args, **kw):
        if not args and kw.get("v0") is None:
            kw["v0"] = np.random.RandomState(seed).uniform(-1.0, 1.0, min(A.shape))
        return real(A, k, *args, **kw)

    spla.svds = svds
    try:
        yield
    finally:
        spla.svds = real


def _leaky_relu(x, slope=0.01):
    """``jax.nn.leaky_relu``: ``where(x >= 0, x, slope * x)``."""
    return torch.where(x >= 0, x, slope * x)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _segment_softmax(scores, segments, n_segments):
    """scores (E, H), segments (E,) -> per-segment softmax along E. The max
    is ``scatter_reduce("amax")``; the sums go through ``scatter_rows``."""
    init = torch.full((n_segments, scores.shape[1]), -1e30, dtype=scores.dtype,
                      device=scores.device)
    m = init.scatter_reduce(0, segments[:, None].expand(-1, scores.shape[1]), scores, "amax",
                            include_self=True)
    ex = torch.exp(scores - gather_rows(m, segments))
    denom = scatter_rows(ex, segments, n_segments)
    return ex / torch.clamp_min(gather_rows(denom, segments), 1e-12)


class HypARGraph:
    """HypAR's device graph: the hyperedges per channel with their degree
    scalings, the review edges, LightGCN's adjacency and the training edges."""

    def __init__(self, model, train_set, dev):
        self.hyper = {c: (torch.as_tensor(np.asarray(n, np.int64), device=dev),
                          torch.as_tensor(np.asarray(s, np.int64), device=dev))
                      for c, (n, s) in model.hyper_edges.items()}
        self.stats = {}
        for c, (n, s) in model.hyper_edges.items():
            dv = np.zeros(model.n_nodes, np.float32)
            np.add.at(dv, n, 1.0)
            de = np.zeros(model.n_sids, np.float32)
            np.add.at(de, s, 1.0)
            self.stats[c] = (torch.as_tensor(1.0 / np.sqrt(np.maximum(dv, 1.0)), device=dev),
                             torch.as_tensor(1.0 / np.maximum(de, 1.0), device=dev))
        rev = np.asarray(model.rev_edges, np.int64).reshape(-1, 3)
        self.rev = tuple(torch.as_tensor(np.ascontiguousarray(rev[:, k]), device=dev)
                         for k in range(3))
        self.adj = NormAdjacency(train_set, device=dev)
        n_i = model.num_items
        self.eu = torch.as_tensor(np.asarray(model.edge_u, np.int64) + n_i, device=dev)
        self.ei = torch.as_tensor(np.asarray(model.edge_i, np.int64), device=dev)
        self.er = torch.as_tensor(np.asarray(model.edge_r, np.float32), device=dev)
        self.aos = torch.as_tensor(np.asarray(model.aos_list, np.int64), device=dev)
        n_edges = len(model.edge_u)
        pos_aos = np.zeros((n_edges, 3), np.int64)
        for k in range(n_edges):
            triples = model.aos_per_sid[model.edge_sid[k]]
            pos_aos[k] = triples[0] if triples else model.aos_list[0]
        self.pos_aos = torch.as_tensor(pos_aos, device=dev)


class HypARNet(torch.nn.Module):
    """HypAR's network: the JAX package's parameters (flattened names, "."
    kept as "/" in the ``ParameterDict``) and its forward pass over a
    ``HypARGraph``."""

    def __init__(self, model, params, graph, ao_feats):
        super().__init__()
        self.m = model
        self.graph = graph
        self.ao_feats = ao_feats
        self.tables = torch.nn.ParameterDict(
            {name.replace(".", "/"): torch.nn.Parameter(t) for name, t in params.items()})

    @property
    def params(self):
        """{flat name: parameter}, the names of the JAX package's tree."""
        return {name.replace("/", "."): p for name, p in self.tables.items()}

    def p(self, name):
        return self.tables[name.replace(".", "/")]

    def _dense(self, h, prefix, act):
        return act(h @ self.p(prefix + ".w") + self.p(prefix + ".b"))

    def initial_x(self):
        if self.m.embedding_type == "learned":
            return self.p("node_emb")
        h = self.ao_feats
        for li in range(3):
            h = self._dense(h, f"ao_mlp.{li}", torch.tanh)
        return torch.cat([self.p("node_emb"), h], dim=0)

    def hyper_conv(self, x, masks):
        """3-layer normalised hypergraph convolution: (node representation,
        review representation). ``masks``: the layers' dropout masks or
        None."""
        m, g = self.m, self.graph
        node_out, review_out = [x], []
        for li in range(3):
            xs, os_ = [], []
            for c, (nodes, sids) in g.hyper.items():
                dv, de = g.stats[c]
                h = x
                if masks is not None and m.layer_dropout[0] > 0:
                    keep = 1.0 - m.layer_dropout[0]
                    h = h * masks[li] / keep
                h = h @ self.p(f"hyper_W.{li}.{c}.w") + self.p(f"hyper_W.{li}.{c}.b")
                # m_e = D_e^-1 H^T D_v^-1/2 h ; e = D_v^-1/2 H m_e
                dv_n = dv[nodes][:, None]
                contrib = gather_rows(h, nodes) * dv_n
                me = scatter_rows(contrib, sids, m.n_sids) * de[:, None]
                e = scatter_rows(gather_rows(me, sids) * dv_n, nodes, h.shape[0])
                if m.non_linear:
                    e = _leaky_relu(e)
                # review representation: O = D_e^-1 H^T e
                o = scatter_rows(gather_rows(e, nodes), sids, m.n_sids) * de[:, None]
                xs.append(e)
                os_.append(o)
            x = sum(xs) / len(xs)
            node_out.append(x)
            review_out.append(sum(os_) / len(os_))
        return sum(node_out) / len(node_out), sum(review_out) / len(review_out)

    def review_agg(self, review_emb, att_mask):
        """NARRE / GATv2 attention over each node's incident reviews:
        (n_nodes, d)."""
        m = self.m
        sids, dst, nid = self.graph.rev
        H, d = m.num_heads, m.node_dim
        h_src = gather_rows(review_emb, sids)
        el = (h_src @ self.p("fc_src")).reshape(-1, H, d)
        if m.review_aggregator == "narre":
            qual = gather_rows(self.p("node_quality"), nid)
            e = el + (qual @ self.p("fc_qual")).reshape(-1, H, d)
        else:
            e = el
        e = _leaky_relu(e, 0.2)
        score = torch.sum(e * self.p("attn"), dim=-1)  # (E, H)
        att = _segment_softmax(score, dst, m.n_nodes)
        if att_mask is not None and m.attention_dropout > 0:
            keep = 1.0 - m.attention_dropout
            att = att * att_mask / keep
        if m.review_aggregator == "narre":
            msg = att[:, :, None] * h_src[:, None, :]
        else:
            msg = att[:, :, None] * el
        agg = scatter_rows(msg.reshape(msg.shape[0], -1), dst, m.n_nodes)
        return agg.reshape(m.n_nodes, H, -1).sum(dim=1)

    def preference(self):
        if self.m.preference_module == "lightgcn":
            u, i = self.graph.adj.lightgcn(self.p("pref_user"), self.p("pref_item"), 3)
        else:
            u, i = self.p("pref_user"), self.p("pref_item")
        # node layout: items first, then users
        return torch.cat([i, u], dim=0)

    def combine(self, r_n, e_pref, node_rep):
        c = self.m.combiner
        if c == "concat":
            return torch.cat([r_n, e_pref], dim=-1)
        if c == "add":
            return r_n + e_pref
        if c == "mul":
            return r_n * e_pref
        if c == "bi-interaction":
            a = self._dense(r_n + e_pref, "add_mlp", torch.tanh)
            b = self._dense(r_n * e_pref, "mul_mlp", torch.tanh)
            return a + b
        if c == "review-only":
            return r_n
        if c == "self":
            return torch.cat([r_n, node_rep], dim=-1)
        return node_rep  # self-only

    def node_embeddings(self, draws=None):
        """Full forward: (node_rep for the explainability loss, e_star for
        prediction); ``draws`` holds a step's dropout masks, or None."""
        m = self.m
        draws = {} if draws is None else draws
        x = self.initial_x()
        node_rep, review_emb = self.hyper_conv(x, draws.get("layer_masks"))
        r_n = self.review_agg(review_emb, draws.get("att_mask"))
        e_pref = self.preference()
        if draws.get("out_mask") is not None and m.layer_dropout[1] > 0:
            keep = 1.0 - m.layer_dropout[1]
            r_n = r_n * draws["out_mask"] / keep
        # e_pref covers the user and item rows; the aspect and opinion rows are 0
        if e_pref.shape[0] < m.n_nodes:
            e_pref = torch.cat([e_pref, e_pref.new_zeros((m.n_nodes - e_pref.shape[0],
                                                          e_pref.shape[1]))], dim=0)
        return node_rep, self.combine(r_n, e_pref, node_rep)

    def predict_pairs(self, e_star, u_nodes, i_nodes):
        u_emb, i_emb = gather_rows(e_star, u_nodes), gather_rows(e_star, i_nodes)
        if self.m.predictor == "dot":
            return torch.sum(u_emb * i_emb, dim=-1)
        h = (u_emb * i_emb) @ self.p("pred_w") + self.p("pred_b")
        bias = self.p("bias")
        return h[:, 0] + gather_rows(bias, u_nodes)[:, 0] + gather_rows(bias, i_nodes)[:, 0]

    def aos_score(self, u_emb, i_emb, a_emb, o_emb, s):
        ui = torch.cat([u_emb, i_emb], dim=-1)
        ao = torch.cat([a_emb, o_emb], dim=-1)
        if self.m.learn_method == "transr":
            ao_t = torch.einsum("bd,bdr->br", ao, self.p("w_aor")[s])
            ui_t = torch.einsum("bd,bdr->br", ui, self.p("w_uir")[s])
            return -torch.sum((ui_t + self.p("r")[s] - ao_t) ** 2, dim=-1)
        # a per-relation MLP for ao, a shared MLP for ui
        outs = []
        for rel in range(2):
            h = ao
            for li in range(3):
                h = self._dense(h, f"mlp_ao.{rel}.{li}", _leaky_relu)
            outs.append(h)
        h_ao = torch.where((s == 0)[:, None], outs[0], outs[1])
        h_ui = ui
        for li in range(3):
            h_ui = self._dense(h_ui, f"mlp_ui.{li}", _leaky_relu)
        return torch.sum(h_ui * h_ao * self.p("r")[s], dim=-1)

    def loss_on(self, draws):
        """The JAX fit's ``loss_fn`` on one step's ``draws`` (``idx``, the
        edges; ``neg``, (B, n_neg) negative items for the ranking objective;
        ``aos_neg``, (B,) for the explainability loss; the dropout masks)."""
        m, g = self.m, self.graph
        idx = draws["idx"]
        node_rep, e_star = self.node_embeddings(draws)
        u, i, r = g.eu[idx], g.ei[idx], g.er[idx]
        pred = self.predict_pairs(e_star, u, i)
        if m.objective == "ranking":
            n_neg = draws["neg"].shape[1]
            pred_j = self.predict_pairs(e_star, u.repeat_interleave(n_neg),
                                        draws["neg"].reshape(-1)).reshape(-1, n_neg)
            loss = torch.mean(_softplus(-(pred[:, None] - pred_j)))
        else:
            loss = torch.mean((pred - r) ** 2)
        if m.learn_explainability:
            pa = g.pos_aos[idx]
            na = g.aos[draws["aos_neg"]]
            last = node_rep.shape[0] - 1

            def rows(ids):
                # a node past the graph's (an opinion of a graph without
                # opinions) reads the last row and sends it no gradient,
                # as the JAX package's out-of-bounds gather does
                return gather_rows(node_rep, ids.clamp(max=last), ids)

            u_emb, i_emb = gather_rows(e_star, u), gather_rows(e_star, i)
            s_i = self.aos_score(u_emb, i_emb, rows(pa[:, 0]), rows(pa[:, 1]), pa[:, 2])
            s_j = self.aos_score(u_emb, i_emb, rows(na[:, 0]), rows(na[:, 1]), na[:, 2])
            loss = loss + m.learn_weight * torch.mean(_softplus(-(s_i - s_j)))
        return loss


def hypar_draws(generator, model, n_edges, bsz, n_batches, device):
    """One epoch's draws: the permutation of the (padded) edges, then for
    each step, in the JAX package's order, the layers' dropout masks, the
    attention's, the review output's, the negatives and the explainability
    negatives (each only where the model uses it). Yields a dict a step,
    drawn as the step comes (an epoch's attention masks at once would take
    gigabytes at a catalog's size)."""
    n_total = n_batches * bsz
    perm = torch.randperm(n_total, generator=generator, device=device) % n_edges
    d, H = model.node_dim, model.num_heads
    n_rev = len(model.rev_edges)
    for b in range(n_batches):
        draws = {"idx": perm[b * bsz:(b + 1) * bsz]}
        if model.layer_dropout[0] > 0:
            keep = 1.0 - model.layer_dropout[0]
            draws["layer_masks"] = [
                (torch.rand((model.n_nodes, d), generator=generator, device=device) < keep)
                .to(torch.float32) for _ in range(3)]
        if model.attention_dropout > 0:
            keep = 1.0 - model.attention_dropout
            draws["att_mask"] = (torch.rand((n_rev, H), generator=generator, device=device)
                                 < keep).to(torch.float32)
        if model.layer_dropout[1] > 0:
            keep = 1.0 - model.layer_dropout[1]
            draws["out_mask"] = (torch.rand((model.n_nodes, d), generator=generator,
                                            device=device) < keep).to(torch.float32)
        if model.objective == "ranking":
            draws["neg"] = torch.randint(0, model.num_items, (bsz, model.num_neg_samples),
                                         generator=generator, device=device)
        if model.learn_explainability:
            draws["aos_neg"] = torch.randint(0, len(model.aos_list), (bsz,),
                                             generator=generator, device=device)
        yield draws


class HypAR(Recommender):
    """Hypergraph attention-on-reviews recommender. Parameters mirror the
    JAX package's; ``device``: where the model fits and scores (default:
    the card); ``mesh`` is refused (ROADMAP.md A8)."""

    def __init__(
        self,
        name="HypAR",
        use_cuda=False,
        stemming=True,
        batch_size=128,
        num_workers=0,
        num_epochs=10,
        early_stopping=10,
        eval_interval=1,
        learning_rate=0.1,
        weight_decay=0,
        node_dim=64,
        num_heads=3,
        fanout=5,
        non_linear=True,
        model_selection="best",
        objective="ranking",
        review_aggregator="narre",
        predictor="narre",
        preference_module="lightgcn",
        combiner="add",
        graph_type="aos",
        num_neg_samples=50,
        layer_dropout=None,
        attention_dropout=0.2,
        user_based=True,
        verbose=False,
        index=0,
        out_path=None,
        learn_explainability=False,
        learn_method="transr",
        learn_weight=1.0,
        embedding_type="ao_embeddings",
        debug=False,
        trainable=True,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        if mesh is not None:
            raise NotImplementedError(f"{name}(mesh=...) is not ported yet (ROADMAP.md A8)")
        if objective not in ("ranking", "rating"):
            raise ValueError("objective must be 'ranking' or 'rating'")
        if combiner not in COMBINERS:
            raise ValueError("combiner must be one of %s" % (COMBINERS,))
        if review_aggregator not in ("narre", "gatv2"):
            raise ValueError("review_aggregator must be 'narre' or 'gatv2'")
        if predictor not in ("narre", "dot"):
            raise ValueError("predictor must be 'narre' or 'dot'")
        if preference_module not in ("lightgcn", "mf"):
            raise ValueError("preference_module must be 'lightgcn' or 'mf'")
        if learn_method not in ("transr", "non-linear"):
            raise ValueError("learn_method must be 'transr' or 'non-linear'")
        if embedding_type not in ("learned", "ao_embeddings"):
            raise ValueError(
                "embedding_type must be 'learned' or 'ao_embeddings'"
            )
        if early_stopping is not None and early_stopping % eval_interval != 0:
            raise ValueError(
                "eval_interval should be a divisor of early_stopping"
            )
        self.mesh = mesh
        self.device = device
        self.use_cuda = use_cuda
        self.stemming = stemming
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.num_epochs = num_epochs
        self.early_stopping = early_stopping
        self.eval_interval = eval_interval
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.node_dim = node_dim
        self.num_heads = num_heads
        self.fanout = fanout
        self.non_linear = non_linear
        self.model_selection = model_selection
        self.objective = objective
        self.review_aggregator = review_aggregator
        self.predictor = predictor
        self.preference_module = preference_module
        self.combiner = combiner
        self.graph_type = graph_type
        self.num_neg_samples = num_neg_samples
        self.layer_dropout = (0.0, 0.0) if layer_dropout is None else (
            (layer_dropout, layer_dropout)
            if np.isscalar(layer_dropout) else tuple(layer_dropout)
        )
        self.attention_dropout = attention_dropout
        self.user_based = user_based
        self.index = index
        self.out_path = out_path
        self.learn_explainability = learn_explainability
        self.learn_method = learn_method
        self.learn_weight = learn_weight
        self.embedding_type = embedding_type
        self.debug = debug
        self.seed = seed
        self.ignored_attrs += ["net", "_e_star", "_scoring"]

    # -------------------------------------------------------- data prep
    def _stem_maps(self, sentiment):
        if not self.stemming:
            a2a = {i: i for i in sentiment.aspect_id_map.values()}
            o2o = {i: i for i in sentiment.opinion_id_map.values()}
            return a2a, o2o
        a_new = {i: _stem_fn(a) for a, i in sentiment.aspect_id_map.items()}
        o_new = {i: _stem_fn(o) for o, i in sentiment.opinion_id_map.items()}
        a_id = {w: i for i, w in enumerate(sorted(set(a_new.values())))}
        o_id = {w: i for i, w in enumerate(sorted(set(o_new.values())))}
        return (
            {i: a_id[w] for i, w in a_new.items()},
            {i: o_id[w] for i, w in o_new.items()},
        )

    def _create_graphs(self, train_set):
        """Node layout: items, users, aspects, opinions."""
        sentiment = train_set.sentiment
        n_u, n_i = self.num_users, self.num_items
        a2a, o2o = self._stem_maps(sentiment)
        n_aspects = max(a2a.values()) + 1
        n_opinions = max(o2o.values()) + 1
        self.a2a, self.o2o = a2a, o2o
        self.n_aspects, self.n_opinions = n_aspects, n_opinions

        n_nodes = n_u + n_i
        if "a" in self.graph_type:
            n_nodes += n_aspects
        if "o" in self.graph_type:
            n_nodes += n_opinions
        self.n_nodes = n_nodes

        channels = ("p", "n") if "s" in self.graph_type else ("n",)
        hyper = {c: [] for c in channels}
        sent_map = {-1: "n", 1: "p"} if "s" in self.graph_type else {-1: "n", 1: "n"}

        # review (sid) edges to user/item for attention aggregation
        rev_edges = []  # (sid, node, other-node)
        sid_ids = sorted(sentiment.sentiment.keys())
        n_sids = max(sid_ids) + 1 if sid_ids else 0
        self.n_sids = n_sids
        R = train_set.csr_matrix

        aos_per_sid = [[] for _ in range(n_sids)]
        for uid, isid in sentiment.user_sentiment.items():
            if uid >= n_u:
                continue
            u_node = uid + n_i
            for iid, sid in isid.items():
                if iid >= n_i:
                    continue
                rev_edges.append((sid, u_node, iid))
                rev_edges.append((sid, iid, u_node))
                first = {c: True for c in channels}
                for aid, oid, s in sentiment.sentiment[sid]:
                    c = sent_map[int(np.sign(s)) if s != 0 else -1]
                    aid_m, oid_m = a2a[aid], o2o[oid]
                    if first[c]:
                        hyper[c].extend([(iid, sid), (u_node, sid)])
                        first[c] = False
                    a_node = aid_m + n_i + n_u
                    o_node = oid_m + n_i + n_u
                    if "a" in self.graph_type:
                        hyper[c].append((a_node, sid))
                        o_node += n_aspects
                    if "o" in self.graph_type:
                        hyper[c].append((o_node, sid))
                    aos_per_sid[sid].append(
                        (
                            aid_m + n_i + n_u,
                            oid_m + n_i + n_u
                            + (n_aspects if "a" in self.graph_type else 0),
                            0 if s == -1 else 1,
                        )
                    )

        self.hyper_edges = {}
        for c, edges in hyper.items():
            if not edges:
                edges = [(0, 0)]
            e = np.asarray(sorted(set(edges)), np.int32)
            self.hyper_edges[c] = (e[:, 0], e[:, 1])
        self.rev_edges = np.asarray(rev_edges, np.int32)  # (E, 3)
        self.aos_per_sid = aos_per_sid
        aos_list = sorted({t for ts in aos_per_sid for t in ts})
        self.aos_list = np.asarray(aos_list if aos_list else [(0, 0, 0)], np.int64)

        # training edges (user node, item node, rating, sid)
        uim = {
            (u, i): sid
            for u, isid in sentiment.user_sentiment.items()
            for i, sid in isid.items()
        }
        uu, ii = R.nonzero()
        self.edge_u = uu.astype(np.int32)
        self.edge_i = ii.astype(np.int32)
        self.edge_r = np.asarray(R[uu, ii]).ravel().astype(np.float32)
        self.edge_sid = np.asarray(
            [uim.get((u, i), 0) for u, i in zip(uu, ii)], np.int32
        )

    def _ao_content_embeddings(self, train_set):
        """SVD of the aspect / opinion x item co-occurrence (the JAX
        package's stand-in for sentence-transformer vectors)."""
        sentiment = train_set.sentiment
        dim = min(64, self.num_items)
        rows_a, cols_a, rows_o, cols_o = [], [], [], []
        for uid, isid in sentiment.user_sentiment.items():
            for iid, sid in isid.items():
                if iid >= self.num_items:
                    continue
                for aid, oid, _ in sentiment.sentiment[sid]:
                    rows_a.append(self.a2a[aid])
                    cols_a.append(iid)
                    rows_o.append(self.o2o[oid])
                    cols_o.append(iid)

        def svd_embed(rows, cols, n_rows):
            M = sp.csr_matrix(
                (np.ones(len(rows), np.float32), (rows, cols)),
                shape=(n_rows, self.num_items),
            )
            M = M.multiply(1.0 / np.maximum(M.sum(axis=1), 1.0))
            k = min(dim, min(M.shape) - 1)
            if k < 1:
                return np.zeros((n_rows, dim), np.float32)
            from scipy.sparse.linalg import svds

            u, s, _ = svds(M.astype(np.float64), k=k)
            out = np.zeros((n_rows, dim), np.float32)
            out[:, :k] = (u * s).astype(np.float32)
            std = out.std(axis=0)
            std[std == 0] = 1.0
            return (out - out.mean(axis=0)) / std

        return (
            svd_embed(rows_a, cols_a, self.n_aspects),
            svd_embed(rows_o, cols_o, self.n_opinions),
        )

    # ----------------------------------------------------------- params
    def _init_params(self, rng, ao_embs):
        """The JAX package's initial parameter tree (numpy draws in its
        order) and the aspect / opinion content features, or None."""
        d = self.node_dim

        def xav(*s):
            std = float(np.sqrt(2.0 / (s[-2] + s[-1]))) if len(s) >= 2 else 0.02
            return rng.normal(0, std, size=s).astype(np.float32)

        def zeros(n):
            return np.zeros(n, np.float32)

        n_ui = self.num_users + self.num_items
        params = {
            "node_emb": xav(n_ui if ao_embs is not None else self.n_nodes, d),
            "hyper_W": [
                {c: {"w": xav(d, d), "b": zeros(d)} for c in self.hyper_edges}
                for _ in range(3)
            ],
            "fc_src": xav(d, d * self.num_heads),
            "attn": xav(1, self.num_heads, d),
            "W_s": xav(d, d),
            "pref_user": xav(self.num_users, d),
            "pref_item": xav(self.num_items, d),
        }
        if self.review_aggregator == "narre":
            params["node_quality"] = xav(self.n_nodes, d)
            params["fc_qual"] = xav(d, d * self.num_heads)
            params["w_0"] = {"w": xav(d, d), "b": zeros(d)}
        final_dim = d * 2 if self.combiner in ("concat", "self") else d
        if self.combiner == "bi-interaction":
            params["add_mlp"] = {"w": xav(d, d), "b": zeros(d)}
            params["mul_mlp"] = {"w": xav(d, d), "b": zeros(d)}
        if self.predictor == "narre":
            params["pred_w"] = xav(final_dim, 1)
            params["pred_b"] = zeros(1)
            params["bias"] = np.zeros((self.n_nodes, 1), np.float32)
        ao_feats = None
        if ao_embs is not None:
            a_emb, o_emb = ao_embs
            feats = []
            if "a" in self.graph_type:
                feats.append(a_emb)
            if "o" in self.graph_type:
                feats.append(o_emb)
            ao_feats = np.asarray(np.concatenate(feats) if feats
                                  else np.zeros((0, 64), np.float32), np.float32)
            dims = [ao_feats.shape[1], 256, 128, d]
            params["ao_mlp"] = [
                {"w": xav(dims[i], dims[i + 1]), "b": zeros(dims[i + 1])}
                for i in range(3)
            ]
        if self.learn_explainability:
            r_dim = 32
            if self.learn_method == "transr":
                params["w_aor"] = xav(2, d * 2, r_dim)
                params["w_uir"] = xav(2, final_dim * 2, r_dim)
                params["r"] = xav(2, r_dim)
            else:
                dims_ao = [d * 2, d, 64, 32]
                dims_ui = [final_dim * 2, d, 64, 32]
                params["mlp_ao"] = [
                    [
                        {"w": xav(dims_ao[i], dims_ao[i + 1]), "b": zeros(dims_ao[i + 1])}
                        for i in range(3)
                    ]
                    for _ in range(2)
                ]
                params["mlp_ui"] = [
                    {"w": xav(dims_ui[i], dims_ui[i + 1]), "b": zeros(dims_ui[i + 1])}
                    for i in range(3)
                ]
                params["r"] = xav(2, 32)
        return params, ao_feats

    def build_net(self, train_set, params, ao_feats, dev):
        """``HypARNet`` on ``dev`` from a (nested or flat) parameter tree of
        arrays, over ``train_set``'s graph (``_create_graphs`` first)."""
        flat = flatten(params)
        tensors = {n: torch.tensor(np.asarray(a, np.float32), device=dev) for n, a in flat.items()}
        feats = None if ao_feats is None else torch.as_tensor(ao_feats, device=dev)
        self._ao_feats = ao_feats
        return HypARNet(self, tensors, HypARGraph(self, train_set, dev), feats)

    # --------------------------------------------------------------- fit
    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if train_set.sentiment is None:
            raise ValueError("this model needs the sentiment modality attached to the eval method")
        rng = get_rng(self.seed)
        dev = self._device()

        self._create_graphs(train_set)
        ao_embs = (
            self._ao_content_embeddings(train_set)
            if self.embedding_type == "ao_embeddings"
            else None
        )
        params, ao_feats = self._init_params(rng, ao_embs)
        self.net = self.build_net(train_set, params, ao_feats, dev)
        if not self.trainable:
            self._cache_inference()
            return self

        n_edges = len(self.edge_u)
        bsz = min(self.batch_size, n_edges)
        n_total = n_edges + ((-n_edges) % bsz)
        n_batches = n_total // bsz
        opt = adamw(self.learning_rate, weight_decay=self.weight_decay)
        params = self.net.params
        opt_state = opt.init(params)

        gen = torch.Generator(device=dev)
        gen.manual_seed(int(rng.randint(2**31)))
        select_best = self.model_selection == "best" and val_set is not None
        best_score, best_params, since_best = -np.inf, None, 0
        for e in range(self.num_epochs):
            loss_sum = torch.zeros((), device=dev)
            for draws in hypar_draws(gen, self, n_edges, bsz, n_batches, dev):
                loss = self.net.loss_on(draws)
                opt_state = optim_step(params, opt, opt_state, loss)
                loss_sum = loss_sum + loss.detach()
            if self.verbose:
                print("Epoch %d/%d, loss: %.4f"
                      % (e + 1, self.num_epochs, float(loss_sum) / n_batches))
            if select_best and (e + 1) % self.eval_interval == 0:
                score = self._val_score(val_set)
                if score > best_score:
                    best_score, since_best = score, 0
                    best_params = {n: p.detach().clone() for n, p in params.items()}
                else:
                    since_best += self.eval_interval
                if (
                    self.early_stopping is not None
                    and since_best >= self.early_stopping
                ):
                    break
        if select_best and best_params is not None:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(best_params[n])
        self._cache_inference()
        return self

    def _val_score(self, val_set):
        """Validation monitor: -MSE (rating) or the pairwise win rate on
        sampled negatives (ranking)."""
        with torch.no_grad():
            _, e_star = self.net.node_embeddings(None)
            vu, vi, vr = val_set.uir_tuple
            ok = (vu < self.num_users) & (vi < self.num_items)
            dev = e_star.device
            u_nodes = torch.as_tensor(np.asarray(vu[ok] + self.num_items, np.int64), device=dev)
            i_nodes = torch.as_tensor(np.asarray(vi[ok], np.int64), device=dev)
            pred = self.net.predict_pairs(e_star, u_nodes, i_nodes)
            if self.objective == "rating":
                vr_t = torch.as_tensor(np.asarray(vr[ok], np.float32), device=dev)
                return -float(torch.mean((pred - vr_t) ** 2))
            rng = np.random.RandomState(0)
            j = torch.as_tensor(rng.randint(0, self.num_items, size=int(ok.sum())).astype(np.int64),
                                device=dev)
            pred_j = self.net.predict_pairs(e_star, u_nodes, j)
            return float(torch.mean((pred > pred_j).to(torch.float32)))

    @property
    def params(self):
        """The fitted parameters as a flat dict of numpy arrays."""
        return {n: p.detach().cpu().numpy() for n, p in self.net.params.items()}

    def _cache_inference(self):
        with torch.no_grad():
            node_rep, e_star = self.net.node_embeddings(None)
        self._e_star = e_star.detach()
        self._node_rep = node_rep.detach()
        if self.predictor == "narre":
            self._scoring = (self.net.p("bias").detach()[:, 0], self.net.p("pred_w").detach()[:, 0],
                             float(self.net.p("pred_b").detach()[0]))

    # ------------------------------------------------------------ scoring
    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        row = self.score_batch(np.array([user_idx]))[0, : self.num_items]
        return row if item_idx is None else float(row[item_idx])

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        e_star = self._e_star
        u_nodes = torch.as_tensor(np.where(known, users, 0).astype(np.int64) + self.num_items,
                                  device=e_star.device)
        u_emb = e_star[u_nodes]
        i_emb = e_star[: self.num_items]
        if self.predictor == "dot":
            scores = u_emb @ i_emb.T
        else:
            bias, pred_w, pred_b = self._scoring
            scores = ((u_emb * pred_w[None, :]) @ i_emb.T + pred_b
                      + bias[u_nodes][:, None] + bias[: self.num_items][None, :])
        scores = scores.to(torch.float64).cpu().numpy()
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)

    def monitor_value(self, train_set=None, val_set=None):
        val_set = val_set if val_set is not None else getattr(self, "val_set", None)
        if val_set is None:
            return None
        return self._val_score(val_set)
