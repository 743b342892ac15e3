"""Prepared-dataset factory: metadata discovery, scene boxes, ray datasets.

The port's own copy of nerfsys_tpu/data/dataset.py (:26-245). It reads the
prepared-dataset format unchanged:

  <root>/coordinates.pt, mappings.txt
  <root>/{train,val}/{metadata,rgbs}/NNNNNN.*          (split layout)
  <root>/{metadata,rgbs}/                              (flat layout)
  <root>/masks/<tag>/{params.pt, scene_boxes.pt, <cid>/NNNNNN.pt}

`get_dataset` reads the masked per-expert layout, the runner's; the
reference's flat mode (no mask dir) and `only_test`, which no code of the
JAX package calls, are left out.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from nerfsys_tpu_torch.data.image_metadata import ImageMetadata, load_pt
from nerfsys_tpu_torch.data.ram_rays import RamRaysDataset


# --------------------------- clustering meta ---------------------------------
def discover_cluster_cells(mask_root: Path) -> int:
    """Count the numeric per-cell mask subdirectories of a mask tag dir."""
    return len([d for d in Path(mask_root).iterdir()
                if d.is_dir() and d.name.isdigit()])


def load_clustering_meta(mask_dir: Path) -> dict:
    """masks/<tag>/params.pt (centroids, grid_dim, cluster_2d, ...)."""
    return load_pt(Path(mask_dir) / "params.pt")


def load_scene_boxes(mask_dir: Path) -> Tuple[np.ndarray, np.ndarray]:
    """masks/<tag>/scene_boxes.pt -> (global_aabb (2, 3), expert_aabbs
    (K, 2, 3))."""
    sb = load_pt(Path(mask_dir) / "scene_boxes.pt")
    global_aabb = np.asarray(sb["aabb_global"], dtype=np.float32)
    mins = np.asarray(sb["mins"], dtype=np.float32)
    maxs = np.asarray(sb["maxs"], dtype=np.float32)
    return global_aabb, np.stack([mins, maxs], axis=1)


def load_coordinates(data_path: Path) -> dict:
    """<root>/coordinates.pt: origin_drb, pose_scale_factor, ..."""
    return load_pt(Path(data_path) / "coordinates.pt")


# --------------------------- metadata discovery -------------------------------
def _list_metadata_files(d: Path) -> List[Path]:
    if not d.exists():
        return []
    return sorted(p for p in d.iterdir() if p.suffix == ".pt")


def get_metadata_item(metadata_path: Path, image_index: int,
                      scale_factor: float, is_val: bool = False,
                      mask_dir: Optional[Path] = None
                      ) -> Optional[ImageMetadata]:
    """One ImageMetadata from its .pt and the sibling rgbs image."""
    image_path = None
    for ext in (".jpg", ".JPG", ".png", ".PNG"):
        cand = (metadata_path.parent.parent / "rgbs"
                / f"{metadata_path.stem}{ext}")
        if cand.exists():
            image_path = cand
            break
    if image_path is None:
        return None
    md = load_pt(metadata_path)
    return ImageMetadata(
        image_path,
        np.asarray(md["c2w"], dtype=np.float32),
        int(round(md["W"] * scale_factor)),
        int(round(md["H"] * scale_factor)),
        np.asarray(md["intrinsics"], dtype=np.float32) * scale_factor,
        image_index, is_val, mask_dir)


def get_image_metadata(data_path, scale_factor: float,
                       mask_dir: Optional[Path] = None
                       ) -> Tuple[List[ImageMetadata], List[ImageMetadata]]:
    """Metadata in the flat layout (<root>/{metadata,rgbs}: everything as
    val) or the split layout (<root>/train + val|test -> (train, val), image
    indices over the filename-sorted union)."""
    root = Path(data_path)

    flat_meta = _list_metadata_files(root / "metadata")
    if flat_meta and (root / "rgbs").exists():
        order = {p.name: i for i, p in
                 enumerate(sorted(flat_meta, key=lambda x: x.name))}
        val = [m for p in flat_meta
               if (m := get_metadata_item(p, order[p.name], scale_factor,
                                          True, mask_dir))]
        return [], val

    train_paths = _list_metadata_files(root / "train" / "metadata")
    eval_paths = (_list_metadata_files(root / "val" / "metadata")
                  or _list_metadata_files(root / "test" / "metadata"))
    if train_paths or eval_paths:
        all_paths = sorted(train_paths + eval_paths, key=lambda x: x.name)
        order = {p.name: i for i, p in enumerate(all_paths)}
        train = [m for p in train_paths
                 if (m := get_metadata_item(p, order[p.name], scale_factor,
                                            False, mask_dir))]
        val = [m for p in eval_paths
               if (m := get_metadata_item(p, order[p.name], scale_factor,
                                          True, mask_dir))]
        return train, val

    return [], []


def cap_metadata(items: List[ImageMetadata], cap: int) -> List[ImageMetadata]:
    """Evenly subsample at most `cap` items."""
    if cap is None or len(items) <= cap:
        return items
    idx = np.linspace(0, len(items) - 1, cap).round().astype(int)
    return [items[i] for i in idx]


# --------------------------- dataset factory ----------------------------------
@dataclasses.dataclass
class DatasetBundle:
    """Everything the train op needs from one prepared dataset.
    `train_cells` / `val_cells` name the expert of each per-expert set (an
    expert whose set holds no ray is dropped, as in the reference)."""

    coordinate_info: dict
    global_aabb: Optional[np.ndarray] = None
    expert_aabbs: Optional[np.ndarray] = None
    clustering: Optional[dict] = None
    train_sets: Optional[List[RamRaysDataset]] = None  # per expert
    val_sets: Optional[List[RamRaysDataset]] = None
    train_metadata: Optional[List[ImageMetadata]] = None  # occ premark
    train_cells: Optional[List[int]] = None
    val_cells: Optional[List[int]] = None


def get_dataset(data_path, downscale: float, mask_dirname: str,
                num_submodules: Optional[int] = None,
                cap_images: Optional[int] = None,
                near_far_override: Optional[Tuple] = None,
                val_balancing: bool = False,
                num_workers: Optional[int] = None) -> DatasetBundle:
    """A RamRaysDataset per expert (train and val) with that expert's scene
    box and pixel masks, from masks/<mask_dirname>."""
    root = Path(data_path)
    bundle = DatasetBundle(coordinate_info=load_coordinates(root))
    mask_root = root / "masks" / mask_dirname
    n_cells = discover_cluster_cells(mask_root)
    if num_submodules is not None and n_cells != num_submodules:
        raise ValueError(f"Mask dir has {n_cells} regions but "
                         f"num_submodules={num_submodules}")
    bundle.clustering = load_clustering_meta(mask_root)
    bundle.global_aabb, bundle.expert_aabbs = load_scene_boxes(mask_root)

    # camera metadata for the occupancy premark (mask-independent)
    all_train_md, _ = get_image_metadata(root, downscale)
    if cap_images is not None:
        all_train_md = cap_metadata(all_train_md, cap_images)
    bundle.train_metadata = all_train_md

    train_sets, val_sets, train_cells, val_cells = [], [], [], []
    for cid in range(n_cells):
        train_md, val_md = get_image_metadata(root, downscale,
                                              mask_root / str(cid))
        if not train_md and not val_md:
            continue
        if cap_images is not None:
            train_md = cap_metadata(train_md, cap_images)
            val_md = cap_metadata(val_md, cap_images)
        aabb = bundle.expert_aabbs[cid]
        ds = RamRaysDataset(train_md, scene_aabb=aabb,
                            near_far_override=near_far_override,
                            num_workers=num_workers)
        if len(ds) > 0:
            train_sets.append(ds)
            train_cells.append(cid)
        if val_md:
            vs = RamRaysDataset(val_md, val_balancing=val_balancing,
                                scene_aabb=aabb,
                                near_far_override=near_far_override,
                                num_workers=num_workers)
            if len(vs) > 0:
                val_sets.append(vs)
                val_cells.append(cid)
    bundle.train_sets, bundle.val_sets = train_sets, val_sets
    bundle.train_cells, bundle.val_cells = train_cells, val_cells
    return bundle
