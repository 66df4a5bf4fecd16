"""Nested dict <-> HDF5 round-trip (a copy of ``xicsrt_tpu/utils/hdf5_dict.py``,
importing h5py at first use).

Equivalent of ``xicsrt/util/mirhdf5.py``: arbitrarily nested dicts of
ndarrays / scalars / strings / lists / None round-trip through HDF5 groups,
with python types recorded as attributes. Also provides the reference's
zip-compressed variants (``mirhdf5.py:120-189``) and regex include/exclude
key filters on save (``mirhdf5.py:333-366``) — e.g. to drop large ray
histories from results files.
"""

from __future__ import annotations

import re

import numpy as np


def _compile_filters(include, exclude):
    """Reference semantics (``mirhdf5.py:333-366``): exclude is applied
    first, include re-includes; giving only ``include`` excludes everything
    else. Patterns are regexes matched against the bare key at EVERY
    nesting level."""
    if include is not None:
        if isinstance(include, str):
            include = [include]
        include = [re.compile(p) for p in include]
        if exclude is None:
            exclude = [".*"]
    if exclude is not None:
        if isinstance(exclude, str):
            exclude = [exclude]
        exclude = [re.compile(p) for p in exclude]
    return include, exclude


def _key_included(key: str, include, exclude) -> bool:
    status = True
    if exclude and any(p.match(key) for p in exclude):
        status = False
    if include and any(p.match(key) for p in include):
        status = True
    return status


def _h5py():
    """h5py, imported at first use: the package imports without it."""
    try:
        import h5py
    except ImportError as err:  # pragma: no cover
        raise ImportError("h5py is required for HDF5 files.") from err
    return h5py


def save(filename: str, data: dict, include=None, exclude=None) -> None:
    h5py = _h5py()
    include, exclude = _compile_filters(include, exclude)
    with h5py.File(filename, "w") as fh:
        _write_group(fh, data, include, exclude)


def load(filename: str) -> dict:
    with _h5py().File(filename, "r") as fh:
        return _read_group(fh)


def save_zip(filename: str, data: dict, **kwargs) -> None:
    """Write the HDF5 file, then move it into a deflate zip archive
    (cf. ``mirhdf5.dictToHdf5Zip`` :120-153)."""
    import pathlib
    import zipfile

    p = pathlib.Path(filename)
    file_z = str(p) if p.suffix == ".zip" else str(p) + ".zip"
    file_h = str(p.parent / p.stem) if p.suffix == ".zip" else str(p)
    save(file_h, data, **kwargs)
    with zipfile.ZipFile(
        file_z, mode="w", compression=zipfile.ZIP_DEFLATED, compresslevel=6
    ) as zf:
        zf.write(file_h, pathlib.Path(file_h).name)
    pathlib.Path(file_h).unlink()


def load_zip(filename: str) -> dict:
    """Extract the single HDF5 member, read it, delete the extraction
    (cf. ``mirhdf5.hdf5ZipToDict`` :156-189)."""
    import pathlib
    import zipfile

    p = pathlib.Path(filename)
    file_z = str(p) if p.suffix == ".zip" else str(p) + ".zip"
    with zipfile.ZipFile(file_z, mode="r") as zf:
        info = zf.infolist()[0]
        info.filename = pathlib.Path(info.filename).name
        extracted = pathlib.Path(p.parent) / info.filename
        zf.extract(info, p.parent)
    data = load(str(extracted))
    extracted.unlink()
    return data


def _write_group(group, data: dict, include=None, exclude=None) -> None:
    for key, value in data.items():
        key = str(key)
        if not _key_included(key, include, exclude):
            continue
        if isinstance(value, dict):
            sub = group.create_group(key)
            sub.attrs["_pytype"] = "dict"
            _write_group(sub, value, include, exclude)
        elif value is None:
            ds = group.create_dataset(key, data=0)
            ds.attrs["_pytype"] = "none"
        elif isinstance(value, str):
            ds = group.create_dataset(key, data=np.bytes_(value))
            ds.attrs["_pytype"] = "str"
        elif isinstance(value, bool):
            ds = group.create_dataset(key, data=int(value))
            ds.attrs["_pytype"] = "bool"
        elif isinstance(value, (int, float, np.generic)):
            ds = group.create_dataset(key, data=value)
            ds.attrs["_pytype"] = "scalar"
        elif isinstance(value, (list, tuple)):
            arr = np.asarray(value)
            if arr.dtype.kind in "fiub":
                ds = group.create_dataset(key, data=arr)
                ds.attrs["_pytype"] = "list"
            else:
                sub = group.create_group(key)
                sub.attrs["_pytype"] = "strlist"
                for ii, item in enumerate(value):
                    sub.create_dataset(str(ii), data=np.bytes_(str(item)))
        elif isinstance(value, np.ndarray):
            ds = group.create_dataset(key, data=value)
            ds.attrs["_pytype"] = "ndarray"
        else:
            ds = group.create_dataset(key, data=np.asarray(value))
            ds.attrs["_pytype"] = "ndarray"


def _read_group(group) -> dict:
    out = {}
    for key in group:
        item = group[key]
        pytype = item.attrs.get("_pytype", None)
        if hasattr(item, "keys") and not hasattr(item, "shape"):
            if pytype == "strlist":
                out[key] = [
                    item[str(ii)][()].decode() for ii in range(len(item.keys()))
                ]
            else:
                out[key] = _read_group(item)
        else:
            value = item[()]
            if pytype == "none":
                out[key] = None
            elif pytype == "str":
                out[key] = value.decode() if isinstance(value, bytes) else str(value)
            elif pytype == "bool":
                out[key] = bool(value)
            elif pytype == "scalar":
                out[key] = value.item() if hasattr(value, "item") else value
            elif pytype == "list":
                out[key] = np.asarray(value).tolist()
            else:
                out[key] = np.asarray(value)
    return out
