"""Checkpoint save/load/resume for params, optimizer state and run config.

Port of nerfsys_tpu/utils/checkpoint.py, with the same file names and tags:

    <run_dir>/{tag}.model        params tree
    <run_dir>/{tag}.optim        optimizer state tree (utils.optim)
    <run_dir>/{tag}.config.json  full run config snapshot
    <run_dir>/{tag}.state.json   {step, best, is_best}
    <run_dir>/{tag}.{name}       an auxiliary tree, e.g. {tag}.occ

tags: 'best' | 'last' | 'step{N}'. The port writes `.model`, `.optim` and
the auxiliary files as a `torch.save` of the tree with its tensors on the
host. It reads those, and the JAX package's, which are flax msgpack
(`serialization.to_bytes`), told apart by content: a zip archive is the
port's own, anything else goes to the msgpack reader below, and a file
that is neither raises ValueError naming its path. The reader needs the
`msgpack` package (imported when a JAX file is read, nowhere else) and
not flax: each array is an ext record of code 1 holding (shape, dtype
name, C-order bytes); arrays over flax's MAX_CHUNK_SIZE arrive as
{"__msgpack_chunked_array__": True, "shape", "chunks"} maps; lists and
tuples arrive as maps keyed "0", "1", .... The JAX package's optimizer
state (optax's NamedTuples) has no reader: eval loads params and grids
only (`load_model_checkpoint`, `load_aux_state`).

Restoring needs live templates (params and optimizer state built from the
pinned ARCH_KEYS config, in the JAX params' nesting, see utils/interop):
the loaded tree must have the template's nesting, shapes and dtypes, and
its tensors land on the template's devices.
"""
from __future__ import annotations

import json
import re
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch


def tree_to_host(tree):
    """A copy of a tree with every tensor detached on the host."""
    if isinstance(tree, dict):
        return {k: tree_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _save_tree(path: Path, tree) -> None:
    torch.save(tree_to_host(tree), path)


def _load_tree(path: Path):
    """A tree written by `_save_tree` (a zip archive) or by the JAX
    package (flax msgpack); anything else raises ValueError."""
    if zipfile.is_zipfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    return load_flax_tree(path)


# numpy dtype names of flax's array records -> torch dtypes; bfloat16 is
# stored as its raw 16 bits
_FLAX_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}


def _flax_array(data: bytes) -> torch.Tensor:
    """One ext record's payload (shape, dtype name, C-order bytes) -> a
    tensor of that dtype."""
    import msgpack

    shape, name, buf = msgpack.unpackb(data, raw=False)
    name = name.decode() if isinstance(name, bytes) else name
    if name not in _FLAX_DTYPES:
        raise ValueError(f"flax array of dtype {name!r} has no torch "
                         f"counterpart here")
    dtype = _FLAX_DTYPES[name]
    raw = torch.int16 if dtype == torch.bfloat16 else dtype
    flat = (torch.frombuffer(bytearray(buf), dtype=raw) if buf
            else torch.empty(0, dtype=raw))  # frombuffer refuses 0 bytes
    return flat.view(dtype).reshape(tuple(shape))


def _flax_ext(code: int, data: bytes):
    # flax's ext codes: 1 an ndarray, 3 a numpy scalar (packed as a 0-d
    # array); 2 (a Python complex) never occurs in these trees
    if code in (1, 3):
        return _flax_array(data)
    raise ValueError(f"flax msgpack ext record of code {code} is not read")


def _index_keys(d: dict) -> bool:
    return bool(d) and set(d) == {str(i) for i in range(len(d))}


def _unchunk(tree):
    """Chunked-array maps -> tensors (flat chunks joined, reshaped)."""
    if not isinstance(tree, dict):
        return tree
    if tree.get("__msgpack_chunked_array__"):
        shape, chunks = tree["shape"], tree["chunks"]
        shape = tuple(shape[str(i)] for i in range(len(shape)))
        flat = torch.cat([chunks[str(i)].reshape(-1)
                          for i in range(len(chunks))])
        return flat.reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_flax_tree(path: Path):
    """The state dict of a file that the JAX package wrote with flax's
    `serialization.to_bytes`: nested dicts (lists still as index-keyed
    maps, which `_restore` matches against the template) of CPU tensors.
    A file that is not msgpack raises ValueError naming it."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError(
            f"reading {path}, a checkpoint of the JAX package (flax "
            f"msgpack), needs the 'msgpack' package") from e
    try:
        tree = msgpack.unpackb(Path(path).read_bytes(), ext_hook=_flax_ext,
                               raw=False, strict_map_key=False)
    except (msgpack.UnpackException, ValueError, TypeError) as e:
        raise ValueError(
            f"{path} is neither a checkpoint of nerfsys_tpu_torch (a "
            f"torch.save archive) nor one of the JAX package (flax "
            f"msgpack): {e}") from e
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: a flax state dict (a msgpack map) "
                         f"expected, found {type(tree).__name__}")
    return _unchunk(tree)


def _restore(template, loaded, where: str = "tree"):
    """`loaded` in the nesting of `template`, each tensor checked against
    the template leaf's shape and dtype and moved to its device."""
    if isinstance(template, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(template):
            found = (sorted(loaded) if isinstance(loaded, dict)
                     else type(loaded).__name__)
            raise ValueError(f"{where}: keys {sorted(template)} expected, "
                             f"found {found}")
        return {k: _restore(template[k], loaded[k], f"{where}.{k}")
                for k in template}
    if isinstance(template, (list, tuple)):
        if isinstance(loaded, dict) and _index_keys(loaded):
            # flax writes sequences as maps keyed "0", "1", ...
            loaded = [loaded[str(i)] for i in range(len(loaded))]
        if (not isinstance(loaded, (list, tuple))
                or len(loaded) != len(template)):
            raise ValueError(f"{where}: a sequence of {len(template)} "
                             f"expected")
        return type(template)(_restore(t, v, f"{where}[{i}]")
                              for i, (t, v) in enumerate(zip(template,
                                                             loaded)))
    if isinstance(template, torch.Tensor):
        if (not isinstance(loaded, torch.Tensor)
                or loaded.shape != template.shape
                or loaded.dtype != template.dtype):
            raise ValueError(
                f"{where}: saved {getattr(loaded, 'shape', None)} "
                f"{getattr(loaded, 'dtype', None)} != template "
                f"{tuple(template.shape)} {template.dtype}")
        return loaded.to(template.device)
    return loaded


def save_checkpoint(run_dir, tag: str, params, opt_state=None,
                    config: Optional[dict] = None, step: int = 0,
                    best: float = float("-inf"),
                    is_best: bool = False) -> Path:
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    _save_tree(run_dir / f"{tag}.model", params)
    if opt_state is not None:
        _save_tree(run_dir / f"{tag}.optim", opt_state)
    if config is not None:
        (run_dir / f"{tag}.config.json").write_text(
            json.dumps(config, indent=2))
    (run_dir / f"{tag}.state.json").write_text(json.dumps(
        {"step": int(step), "best": float(best), "is_best": bool(is_best)}))
    return run_dir / f"{tag}.model"


def load_checkpoint(run_dir, tag: str, params_template,
                    opt_state_template=None) -> Tuple[Any, Any, Dict]:
    """-> (params, opt_state or None, state dict {step, best, is_best})."""
    run_dir = Path(run_dir)
    model_path = run_dir / f"{tag}.model"
    if not model_path.exists():
        raise FileNotFoundError(model_path)
    params = _restore(params_template, _load_tree(model_path), "params")

    opt_state = None
    opt_path = run_dir / f"{tag}.optim"
    if opt_state_template is not None and opt_path.exists():
        opt_state = _restore(opt_state_template, _load_tree(opt_path),
                             "opt_state")

    state = {"step": 0, "best": float("-inf"), "is_best": False}
    state_path = run_dir / f"{tag}.state.json"
    if state_path.exists():
        state.update(json.loads(state_path.read_text()))
    return params, opt_state, state


def load_model_checkpoint(run_dir, tag: str, params_template):
    """Params only (the eval path) -> (params, state dict)."""
    params, _, state = load_checkpoint(run_dir, tag, params_template)
    return params, state


def checkpoint_exists(run_dir, tag: str) -> bool:
    return (Path(run_dir) / f"{tag}.model").exists()


def latest_step_tag(run_dir) -> Optional[str]:
    """The highest 'step{N}' tag present, else 'last' if present, else
    None."""
    run_dir = Path(run_dir)
    if not run_dir.exists():
        return None
    best_n, best_tag = -1, None
    for f in run_dir.glob("step*.model"):
        m = re.fullmatch(r"step(\d+)\.model", f.name)
        if m and int(m.group(1)) > best_n:
            best_n, best_tag = int(m.group(1)), f.stem
    if best_tag:
        return best_tag
    if (run_dir / "last.model").exists():
        return "last"
    return None


def resolve_checkpoint_dir(path, logs_root: Optional[str] = None) -> Path:
    """A checkpoint directory, descending into the newest run subdirectory
    when the given one holds no checkpoint itself."""
    p = Path(path)
    if not p.exists() and logs_root is not None:
        cand = Path(logs_root) / path
        if cand.exists():
            p = cand
    if not p.is_dir():
        return p
    if any(p.glob("*.model")) or any(p.glob("*.P")):
        return p
    subdirs = sorted((d for d in p.iterdir() if d.is_dir()),
                     key=lambda d: d.stat().st_mtime)
    for d in reversed(subdirs):
        if any(d.glob("*.model")) or any(d.glob("*.P")):
            return d
    return p


def is_resume(run_dir, params_template, opt_state_template=None,
              tag: str = "last"):
    """The full train state if a checkpoint exists -> (params, opt_state,
    state), or None; a failed restore warns and gives None."""
    if run_dir is None:
        return None
    tag = tag if checkpoint_exists(run_dir, tag) else latest_step_tag(run_dir)
    if tag is None:
        return None
    try:
        return load_checkpoint(run_dir, tag, params_template,
                               opt_state_template)
    except Exception as e:  # degrade to a warning like the reference
        print(f"[WARN] checkpoint restore failed ({e}); starting fresh")
        return None


def save_aux_state(run_dir, tag: str, name: str, state) -> Path:
    """Save an auxiliary tree beside a checkpoint: <tag>.<name> (the
    occupancy grids live there, so params stay a pure learnable tree)."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    path = run_dir / f"{tag}.{name}"
    _save_tree(path, state)
    return path


def load_aux_state(run_dir, name: str, template, tag: Optional[str] = None):
    """Load <tag>.<name> (default: 'last', else the latest step tag, else
    'best'); None if absent or unreadable. A flat dict saved before a new
    leaf existed (e.g. the occupancy's 'ready_after') restores by key: saved
    keys override the template, missing keys keep the template's value;
    a shape change still gives None."""
    run_dir = Path(run_dir)
    tags = [tag] if tag else ["last", latest_step_tag(run_dir), "best"]
    for t in tags:
        if t is None:
            continue
        path = run_dir / f"{t}.{name}"
        if not path.exists():
            continue
        try:
            raw = _load_tree(path)
        except Exception as e:
            print(f"[WARN] aux state {path.name} unreadable ({e})")
            return None
        try:
            return _restore(template, raw, name)
        except Exception as e:
            try:
                if isinstance(raw, dict) and isinstance(template, dict):
                    merged = {}
                    for k, tv in template.items():
                        if k in raw:
                            rv = torch.as_tensor(raw[k])
                            if rv.shape != tv.shape:
                                raise ValueError(
                                    f"leaf {k!r}: saved shape "
                                    f"{tuple(rv.shape)} != template "
                                    f"{tuple(tv.shape)}")
                            merged[k] = rv.to(dtype=tv.dtype,
                                              device=tv.device)
                        else:
                            merged[k] = tv
                    print(f"[WARN] aux state {path.name}: strict restore "
                          f"failed ({e}); merged by key instead")
                    return merged
            except Exception as e2:
                e = e2
            print(f"[WARN] aux state {path.name} unreadable ({e})")
            return None
    return None

