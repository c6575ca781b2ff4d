"""Atlas checkpoint and resume (System::SaveAtlas / LoadAtlas,
System.cc:1014-1098).

The port's own copy of movslam_tpu/core/checkpoint.py (numpy only). The
pointer web is flattened to id-keyed plain structures and written as an npz
archive: a JSON structure string plus numbered numpy arrays, loaded with
allow_pickle=False so that restoring a checkpoint never runs code from the
file. The record keys are the reference's, so a file written by either
package loads in the other. Static id counters are restored past the loaded
ids (Atlas.h:56-61).

As in the reference, stereo and visual-inertial state is not saved: a loaded
keyframe has no depth_right / uright, velocity or biases, and a loaded map
is not IMU-initialized.
"""
from __future__ import annotations

import itertools
import json

import numpy as np

from .map import Atlas, KeyFrame, Map, MapPoint

# --- JSON + npz codec --------------------------------------------------------
# Nested dict/list structures of plain scalars serialize as JSON; numpy
# arrays go into numbered npz members referenced by index. Dicts with
# non-string keys (obs: kf_id -> slot, covis: kf_id -> weight) are written as
# explicit pair lists.


def _encode(obj, arrays):
    if isinstance(obj, np.ndarray):
        arrays.append(obj)
        return {"__nd__": len(arrays) - 1}
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    if isinstance(obj, dict):
        if all(isinstance(k, str) for k in obj):
            return {k: _encode(v, arrays) for k, v in obj.items()}
        return {"__pairs__": [[_encode(k, arrays), _encode(v, arrays)] for k, v in obj.items()]}
    if isinstance(obj, set):
        return [_encode(v, arrays) for v in sorted(obj)]
    if isinstance(obj, (list, tuple)):
        return [_encode(v, arrays) for v in obj]
    return obj  # int / float / str / bool / None


def _decode(obj, arrays):
    if isinstance(obj, dict):
        if "__nd__" in obj:
            return arrays[obj["__nd__"]]
        if "__pairs__" in obj:
            return {_decode(k, arrays): _decode(v, arrays) for k, v in obj["__pairs__"]}
        return {k: _decode(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v, arrays) for v in obj]
    return obj


def _dump_npz(data, filename):
    arrays = []
    structure = json.dumps(_encode(data, arrays))
    # Through a file object: np.savez would append ".npz" to other names.
    with open(filename, "wb") as f:
        np.savez_compressed(
            f, structure=np.frombuffer(structure.encode(), np.uint8),
            **{f"a{i}": a for i, a in enumerate(arrays)},
        )


def _load_npz(filename):
    with np.load(filename, allow_pickle=False) as z:
        structure = json.loads(bytes(z["structure"]).decode())
        n = sum(1 for k in z.files if k.startswith("a"))
        arrays = [z[f"a{i}"] for i in range(n)]
    return _decode(structure, arrays)


def _desc_words(kf):
    """The keyframe's descriptors as uint32 (n, 8). Reading kf.desc pulls a
    windowed keyframe's lazily archived rows from the device."""
    d = kf.desc
    if d is None:
        return None
    d = np.ascontiguousarray(d)
    return d.view(np.uint32) if d.dtype == np.int32 else d.astype(np.uint32, copy=False)


def _kf_record(kf):
    return {
        "id": kf.id, "frame_id": kf.frame_id, "timestamp": kf.timestamp,
        "R": kf.R, "t": kf.t, "track_ids": kf.track_ids, "pts": kf.pts,
        "desc": _desc_words(kf), "mp_ids": kf.mp_ids, "covis": kf.covis,
        "parent": kf.parent.id if kf.parent else -1,
        "children": sorted(kf.children), "map_id": kf.map_id,
        "prev_kf": kf.prev_kf.id if kf.prev_kf else -1,
        "next_kf": kf.next_kf.id if kf.next_kf else -1,
        "image": kf.image,
    }


def _mp_record(mp):
    return {
        "id": mp.id, "track_id": mp.track_id, "pos": mp.pos,
        "first_kf_id": mp.first_kf_id, "map_id": mp.map_id, "obs": mp.obs,
        "normal": mp.normal, "min_dist": mp.min_dist, "max_dist": mp.max_dist,
        "n_visible": mp.n_visible, "n_found": mp.n_found,
    }


def save_atlas(atlas, filename):
    data = {"maps": [
        {
            "id": m.id,
            "init_kf_id": m.init_kf_id,
            "keyframes": [_kf_record(kf) for kf in m.keyframes.values()],
            "mappoints": [_mp_record(mp) for mp in m.mappoints.values()],
            "current": m is atlas.current,
        }
        for m in atlas.all_maps()
    ]}
    _dump_npz(data, filename)


def _load_keyframe(r):
    """A KeyFrame from its record. Every slot the port reads is set; the
    state the checkpoint does not carry (stereo, visual-inertial, the pose
    relative to a culled parent) is None."""
    kf = KeyFrame.__new__(KeyFrame)
    kf.id = r["id"]
    kf.frame_id = r["frame_id"]
    kf.timestamp = r["timestamp"]
    kf.R, kf.t = r["R"], r["t"]
    kf.track_ids, kf.pts = r["track_ids"], r["pts"]
    kf.desc = r["desc"]  # also clears the lazy-descriptor thunk
    kf.mp_ids = r["mp_ids"]
    kf.image = r["image"]
    kf.covis = r["covis"]
    kf.parent = kf.prev_kf = kf.next_kf = None  # resolved once every keyframe exists
    kf.children = set(r["children"])
    kf.bad = False
    kf.map_id = r["map_id"]
    kf.depth_right = kf.uright = None
    kf.Tcp = None
    kf.velocity = kf.bias_g = kf.bias_a = None
    return kf


def _load_mappoint(r):
    mp = MapPoint.__new__(MapPoint)
    mp.id = r["id"]
    mp.track_id = r["track_id"]
    mp.pos = r["pos"]
    mp.first_kf_id = r["first_kf_id"]
    mp.map_id = r["map_id"]
    mp.obs = r["obs"]
    mp.normal = r["normal"]
    mp.min_dist, mp.max_dist = r["min_dist"], r["max_dist"]
    mp.n_visible, mp.n_found = r["n_visible"], r["n_found"]
    mp.bad = False
    mp.replaced_by = None
    mp.track_in_view = False
    mp.track_proj = np.zeros(2)
    mp.track_depth = 0.0
    mp.last_frame_seen = -1
    return mp


def load_atlas(filename):
    data = _load_npz(filename)
    atlas = Atlas()
    atlas.maps.clear()
    max_kf_id = max_mp_id = max_map_id = -1
    for mrec in data["maps"]:
        m = Map()
        # The saved map id: kf.map_id / mp.map_id refer to it.
        m.id = mrec["id"]
        max_map_id = max(max_map_id, m.id)
        m.init_kf_id = mrec["init_kf_id"]
        for r in mrec["keyframes"]:
            kf = _load_keyframe(r)
            m.keyframes[kf.id] = kf
            max_kf_id = max(max_kf_id, kf.id)
        for r in mrec["keyframes"]:
            kf = m.keyframes[r["id"]]
            kf.parent = m.keyframes.get(r["parent"])
            kf.prev_kf = m.keyframes.get(r["prev_kf"])
            kf.next_kf = m.keyframes.get(r["next_kf"])
        for r in mrec["mappoints"]:
            mp = _load_mappoint(r)
            m.mappoints[mp.id] = mp
            max_mp_id = max(max_mp_id, mp.id)
        atlas.maps.append(m)
        if mrec["current"]:
            atlas.current = m
    if atlas.current is None and atlas.maps:
        atlas.current = atlas.maps[-1]
    KeyFrame._next_id = itertools.count(max_kf_id + 1)
    MapPoint._next_id = itertools.count(max_mp_id + 1)
    Map._next_id = itertools.count(max_map_id + 1)
    return atlas
