"""MCF — Matrix Co-Factorization of ratings and an item affinity network
(Park, Kim & Choi, 2017).

Port of ``cornac_tpu/models/mcf.py``: the ratings (U, V) and the item-item
network (V, Z) co-factorised with a shared item table. Each epoch runs the
item-graph stream (V, Z) and then the rating stream (U, V) through the
shared RMSProp stream epoch (``ops.rmsprop``), in orders the fit's numpy
generator draws, as the JAX package's fit draws them. Scoring is SoRec's,
and so is ``mesh`` (``models/sorec.py``): the tables and caches row-sharded
over "model", the single-device fit's bits on every layout.
"""

from ..exception import ScoreException
from ..ops.rmsprop import run_stream_epoch
from ..parallel.mesh import check_mesh
from ..utils import get_rng
from .recommender import Recommender
from .sorec import _StreamCoFactor, scaled_ratings, stream_tensors


class MCF(_StreamCoFactor):
    """Co-factorise ratings (U, V) and the item-item network (V, Z).

    Parameters mirror the JAX package: ``k``, ``max_iter``,
    ``learning_rate``, ``gamma`` (the caches' decay), ``lamda`` (the
    regularisation), ``batch_size``, ``init_params`` ({'U', 'V', 'Z'}),
    ``seed``. ``device``: where the model trains and scores (default: the
    card). ``mesh``: a ``parallel.make_mesh`` mesh; every rank calls
    ``fit``, and the factors equal the single-device fit's.
    """

    def __init__(
        self,
        name="MCF",
        k=5,
        max_iter=100,
        learning_rate=0.001,
        gamma=0.9,
        lamda=0.001,
        batch_size=1024,
        trainable=True,
        verbose=False,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        Recommender.__init__(self, name=name, trainable=trainable, verbose=verbose)
        self.k = k
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.gamma = gamma
        self.lamda = lamda
        self.batch_size = batch_size
        self.seed = seed
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device

        self.init_params = {} if init_params is None else init_params
        self.U = self.init_params.get("U", None)
        self.V = self.init_params.get("V", None)
        self.Z = self.init_params.get("Z", None)

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if not self.trainable:
            return self

        rng = get_rng(self.seed)
        U, V, Z = self._tables(self.num_items, rng)
        rat_uid, rat_iid, rat_val = train_set.uir_tuple
        items = set(rat_iid)
        net_iid, net_jid, net_val = train_set.item_graph.get_train_triplet(items, items)
        rat_val = scaled_ratings(rat_val, self.min_rating, self.max_rating)
        if len(net_val) > 0:
            net_val = scaled_ratings(net_val, min(net_val), max(net_val))

        dev = U.device
        net = stream_tensors(net_iid, net_jid, net_val, dev)
        rat = stream_tensors(rat_uid, rat_iid, rat_val, dev)
        rows = [t.shape[0] for t in (U, V, Z)]
        (U, V, Z), (cu, cv, cz) = self._stream_state(U, V, Z)
        lr, reg = self.learning_rate, self.lamda
        for epoch in range(self.max_iter):
            loss = 0.0
            if len(net_val) > 0:
                loss = run_stream_epoch(V, Z, cv, cz, *net, rng, lr, lr, reg, self.gamma,
                                        self.batch_size, mesh=self.mesh)
            loss = loss + run_stream_epoch(U, V, cu, cv, *rat, rng, lr, lr, reg, self.gamma,
                                           self.batch_size, mesh=self.mesh)
            if self.verbose:
                print("epoch %i, loss: %f" % (epoch, float(loss)))

        self._store_state((U, V, Z), rows)
        return self

    def score(self, user_idx, item_idx=None):
        if item_idx is None:
            if not self.knows_user(user_idx):
                raise ScoreException("Can't make score prediction for (user_id=%d)" % user_idx)
            return self.V.dot(self.U[user_idx, :])
        if not (self.knows_user(user_idx) and self.knows_item(item_idx)):
            raise ScoreException("Can't make score prediction for (user_id=%d, item_id=%d)"
                                 % (user_idx, item_idx))
        return self._unscaled(self.V[item_idx, :].dot(self.U[user_idx, :]))
