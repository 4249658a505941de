"""Image modality: a copy of ``cornac_tpu/data/image.py`` (visual
features aligned with entity indices; raw images are not loaded)."""

from .modality import FeatureModality


class ImageModality(FeatureModality):
    """Visual features and/or raw images aligned with entity indices.

    Parameters
    ----------
    images: list or ndarray, optional
        Raw images, rows aligned with ``ids``.
    paths: list of str, optional
        On-disk image paths aligned with ``ids``.
    """

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.images = kwargs.get("images", None)
        self.paths = kwargs.get("paths", None)

    def build(self, id_map=None, **kwargs):
        super().build(id_map=id_map)
        return self

    def batch_image(
        self, batch_ids, target_size=(256, 256), color_mode="rgb", interpolation="nearest"
    ):
        """Load/resize a batch of raw images (not needed by the bundled
        models, which consume precomputed visual features)."""
        raise NotImplementedError
