"""Checkpointing, the counterpart of the reference's
``repro/checkpoint/store.py``, with its on-disk format: leaves saved as
individual ``.npy`` files under a step directory with a JSON manifest of
the tree's leaf paths (``params/layers/0/attn/wq``: dict keys and list
indices joined by ``/``), written in sorted path order.

``restore`` rebuilds a tree of ``like``'s structure, each leaf on the
device of ``like``'s leaf (the CPU where ``like`` holds no tensor there).
bfloat16 leaves, which numpy has no type for, are saved as their 16-bit
patterns with ``"dtype": "bfloat16"`` in the manifest.

Not here: the multi-host layout (``save_sharded``, one file per
addressable shard, and its reassembly) and resharding onto a mesh, which
come with the scale-out runtime (ROADMAP step 10): ``restore`` given
``shardings`` raises :class:`NotImplementedError`.

Atomicity: writes go to ``<dir>.tmp``; commit renames the previous step
directory aside, moves the tmp dir in, then deletes the old one — at every
instant there is a complete checkpoint on disk (the old one until the
rename, the new one after).
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """Typed checkpoint failure: manifest/tree mismatch or missing leaf."""


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{leaf path: leaf}: dict keys and list indices joined by ``/``, as
    the reference's ``tree_flatten_with_path`` keys."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _commit(d: Path, tmp: Path) -> None:
    """Atomically replace ``d`` with ``tmp``: rename the live dir aside,
    move tmp in, then delete — never a window with no valid checkpoint."""
    old = Path(str(d) + ".old")
    if old.exists():
        shutil.rmtree(old)
    if d.exists():
        os.rename(d, old)
    os.rename(tmp, d)
    if old.exists():
        shutil.rmtree(old)


def _to_numpy(leaf):
    """(array, manifest dtype) of a leaf: a tensor's values on the host
    (bfloat16 as its int16 bit patterns), or a number as numpy has it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, state) -> str:
    d = Path(ckpt_dir) / f"step_{step:08d}"
    tmp = Path(str(d) + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = _flatten(state)
    manifest = {"step": step, "leaves": {}}
    for i, (key, leaf) in enumerate(sorted(flat.items())):
        arr, dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][key] = {"file": fname, "dtype": dtype,
                                   "shape": list(arr.shape)}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    _commit(d, tmp)
    return str(d)


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")
             if not (p.name.endswith(".tmp") or p.name.endswith(".old"))]
    return max(steps) if steps else None


def _load_leaf(d: Path, key: str, meta: Dict, like) -> torch.Tensor:
    if "shards" in meta:
        raise NotImplementedError(
            f"checkpoint leaf {key!r} was saved as per-host shard files; "
            f"reassembling shards comes with the scale-out runtime "
            f"(ROADMAP step 10)")
    f = d / meta["file"]
    if not f.exists():
        raise CheckpointError(
            f"checkpoint leaf {key!r}: file {meta['file']} missing "
            f"from {d}")
    arr = np.load(f)
    t = torch.from_numpy(arr)
    if meta["dtype"] == "bfloat16":
        t = t.view(torch.bfloat16)
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device)


def restore(ckpt_dir: str, step: int, like, shardings=None):
    """Rebuild ``like``-structured state, each leaf on the device of
    ``like``'s leaf.

    Raises :class:`CheckpointError` naming the leaf when the manifest and
    the ``like`` tree disagree (optimizer or architecture changed between
    save and restore) or when a leaf's file is missing. Resharding onto a
    mesh (``shardings``) comes with the scale-out runtime and raises
    :class:`NotImplementedError`.
    """
    if shardings is not None:
        raise NotImplementedError(
            "restore onto shardings (a mesh) comes with the scale-out "
            "runtime (ROADMAP step 10); the port restores onto one device")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat_like = _flatten(like)
    out = {}
    for key, leaf in flat_like.items():
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise CheckpointError(
                f"checkpoint step {step} has no leaf {key!r}: the saved "
                f"manifest ({len(manifest['leaves'])} leaves) does not "
                f"match the restore target tree — optimizer or model "
                f"architecture changed between save and restore")
        out[key] = _load_leaf(d, key, meta, leaf)

    def build(node, prefix=""):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, f"{prefix}{i}/")
                              for i, v in enumerate(node))
        return out[prefix[:-1]]
    return build(like)


def manifest_for(ckpt_dir: str, step: int) -> Dict:
    d = Path(ckpt_dir) / f"step_{step:08d}"
    return json.loads((d / "manifest.json").read_text())
