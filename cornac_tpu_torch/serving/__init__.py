"""Model serving. Run the stdlib server with:
``MODEL_PATH=... MODEL_CLASS=... python -m cornac_tpu_torch.serving.standalone``
"""
