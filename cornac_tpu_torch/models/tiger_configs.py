"""Ready-made TIGER configurations, copied from
``cornac_tpu/models/tiger_configs.py``.

Capability parity with reference ``cornac/models/tiger/grid_config.py`` and
``tiger/paischer_config.py`` — the GRID handbook recipe (fast, tokenizer is
residual k-means, no gradient training) and the Paischer et al. recipes
(best documented reproduction accuracy, per-dataset variants)."""

GRID_CONFIG = dict(
    tokenizer="rkmeans",
    learning_rate=5e-4,
    weight_decay=1e-6,
    batch_size=256,
    lr_schedule="constant",
    model_selection="best",
    val_metric="ndcg",
    val_k=10,
    n_epochs=50,
    val_eval_every=1,
    val_sample=2000,
)

PAISCHER_CONFIG = dict(
    tokenizer="rqvae",
    feature_standardize=True,
    rqvae_hidden_dims=(768, 512, 256),
    rqvae_latent_dim=128,
    rqvae_n_epochs=8000,
    rqvae_batch_size=2048,
    rqvae_weight_decay=0.1,
    num_enc_layers=6,
    num_dec_layers=6,
    dropout=0.2,
    learning_rate=3e-4,
    lr_schedule="cosine",
    warmup_steps=10000,
    weight_decay=0.035,
    batch_size=64,
    n_beams=30,
    model_selection="best",
    val_metric="ndcg",
    val_k=10,
    n_epochs=100,
    val_eval_every=5,
    val_sample=2000,
)

PAISCHER_SPORTS_CONFIG = dict(
    PAISCHER_CONFIG,
    learning_rate=1e-4,
    batch_size=256,
    n_beams=10,
)

PAISCHER_TOYS_CONFIG = dict(
    PAISCHER_CONFIG,
    d_model=196,
    d_ff=1536,
    n_epochs=50,
    warmup_steps=5000,
    n_beams=10,
)
