"""MMMF — Maximum Margin Matrix Factorization (Weimer et al., 2008).

Port of ``cornac_tpu/models/mmmf.py``: BPR whose SGD step takes a
unit-magnitude hinge update on misordered pairs instead of the sigmoid
gradient (``variant="hinge"`` of the BPR trainer).
"""

from .bpr import BPR


class MMMF(BPR):
    """Max-margin pairwise ranking MF."""

    _variant = "hinge"

    def __init__(
        self,
        name="MMMF",
        k=10,
        max_iter=100,
        learning_rate=0.001,
        lambda_reg=0.001,
        num_threads=0,
        batch_size=1024,
        trainable=True,
        verbose=False,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(
            name=name,
            k=k,
            max_iter=max_iter,
            learning_rate=learning_rate,
            lambda_reg=lambda_reg,
            use_bias=True,
            num_threads=num_threads,
            batch_size=batch_size,
            trainable=trainable,
            verbose=verbose,
            init_params=init_params,
            seed=seed,
            mesh=mesh,
            device=device,
        )
