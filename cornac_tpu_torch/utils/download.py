"""The dataset loaders' file cache, offline.

Port of ``cornac_tpu/utils/download.py``'s cache layer: a data file lives
under a cache directory (``~/.cornac_tpu`` by default, ``CORNAC_TPU_CACHE``
to override, the JAX package's, so both read the same files), and archives
found there are extracted with a path-traversal guard. This package fetches
nothing: a file that is not in the cache raises ``FileNotFoundError`` at
once, naming the URL it comes from and where to put it.
"""

import os
import tarfile
import zipfile


def get_cache_dir():
    cache_dir = os.environ.get(
        "CORNAC_TPU_CACHE", os.path.join(os.path.expanduser("~"), ".cornac_tpu")
    )
    os.makedirs(cache_dir, exist_ok=True)
    return cache_dir


def get_cache_path(relative_path, cache_dir=None):
    """Absolute path a cached data file would live at (reference
    ``utils/download.py:110-125``). Returns ``(cache_path, cache_dir)``
    and creates the parent directory."""
    if cache_dir is None:
        cache_dir = get_cache_dir()
    if not os.access(cache_dir, os.W_OK):
        cache_dir = os.path.join("/tmp", ".cornac_tpu")
    cache_path = os.path.join(cache_dir, relative_path)
    os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
    return cache_path, cache_dir


def _is_within_directory(directory, target):
    abs_directory = os.path.abspath(directory)
    abs_target = os.path.abspath(target)
    return os.path.commonpath([abs_directory]) == os.path.commonpath(
        [abs_directory, abs_target]
    )


def _safe_extract_tar(tar, path):
    for member in tar.getmembers():
        member_path = os.path.join(path, member.name)
        if not _is_within_directory(path, member_path):
            raise RuntimeError("Attempted path traversal in tar file")
    tar.extractall(path)


def _safe_extract_zip(zf, path):
    for name in zf.namelist():
        member_path = os.path.join(path, name)
        if not _is_within_directory(path, member_path):
            raise RuntimeError("Attempted path traversal in zip file")
    zf.extractall(path)


def _extract_archive(fpath, extract_dir):
    if zipfile.is_zipfile(fpath):
        with zipfile.ZipFile(fpath, "r") as zf:
            _safe_extract_zip(zf, extract_dir)
    elif tarfile.is_tarfile(fpath):
        with tarfile.open(fpath, "r") as tar:
            _safe_extract_tar(tar, extract_dir)
    else:
        raise ValueError("Unknown archive format: {}".format(fpath))


def cache(url, unzip=False, relative_path=None, cache_dir=None):
    """The local path of ``url``'s data file in the cache.

    Parameters
    ----------
    url: str
        Where the file comes from (its basename is the archive's or the
        file's name in the cache).
    unzip: bool, default: False
        The file of interest is inside the archive: extract it when the
        archive is in the cache and the file is not yet.
    relative_path: str, optional
        Path (relative to the cache dir) of the file of interest. Defaults
        to the URL basename.
    cache_dir: str, optional
        Override the cache directory.

    Raises ``FileNotFoundError`` when neither the file nor its archive is in
    the cache: nothing is downloaded.
    """
    if cache_dir is None:
        cache_dir = get_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)

    if relative_path is None:
        relative_path = url.split("/")[-1]
    cached_fpath = os.path.join(cache_dir, relative_path)
    if os.path.exists(cached_fpath):
        return cached_fpath

    archive_fpath = os.path.join(cache_dir, url.split("/")[-1])
    if not os.path.exists(archive_fpath):
        raise FileNotFoundError(
            "{} is not in the cache {}, and this package downloads nothing: put {} "
            "there as {}".format(relative_path, cache_dir, url, archive_fpath)
        )
    if unzip:
        _extract_archive(archive_fpath, cache_dir)
    if not os.path.exists(cached_fpath):
        raise FileNotFoundError(
            "{} not found in the cache after extracting {}".format(cached_fpath, archive_fpath)
        )
    return cached_fpath
