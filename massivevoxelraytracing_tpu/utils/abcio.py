"""Alembic (`.abc`, Ogawa flavor) PolyMesh reader + fixture writer.

Covers the subset the reference's production path consumes
(voxUtil.hpp:8-66, RTCamp.cpp:95-109): per-frame triangle meshes with
point positions `P`, `.faceIndices`, `.faceCounts`, and the point-scope
`Cd` / `Emission` vector attributes under `.arbGeomParams`; uniform time
sampling; transforms expected pre-baked into P (the reference bakes
localToWorld at read, voxUtil.hpp:32; Xform objects here are traversed but
treated as identity, with a warning when one carries animated values).

Layout follows Alembic's AbcCoreOgawa (v1.7/1.8):

  root group:  [0] data  i32 spec version
               [1] data  i32 writer version
               [2] group top object
               [3] data  archive metadata string ("a=b;c=d")
               [4] data  time samplings: per sampling
                         u32 maxSample | f64 timePerCycle
                         | u32 numPerCycle | numPerCycle x f64 times
               [5] data  indexed metadata: sequence of u8-size-prefixed
                         strings (index 0 = "", implicit)
  object group: [0] group   compound-property root (.prop)
                [1..n] group child objects
                [last] data  child object headers: per child
                         u32 nameSize | name
                         | u8 metaIndex (0xff => u32 size | inline bytes)
  compound group: [0..m-1] per-subproperty groups
                  [last] data property headers: per property
                         u32 info | (scalar/array) nsi-coded sample count
                         | name + metadata like object headers
                info bits: 0-1 property type (0 compound, 1 scalar,
                2 array); 2-3 size hint (0/1/2 => u8/u16/u32 counts);
                4-7 POD type; 8 hasTimeSamplingIndex; 12-19 extent
  array property group: sample i at children [2i] (data: 16-B sample key
                digest | raw little-endian POD payload) and [2i+1]
                (data: u64 dims, empty => rank-1 inferred from size)
  scalar property group: sample i at child [i] (16-B key | payload)

Validation caveat (documented, not hidden): this environment has no
Alembic SDK, no Houdini/Blender, zero egress, and the reference bundle
ships no .abc archive, so cross-validation against SDK-written files is
impossible here; the format above is implemented from the AbcCoreOgawa
layout and validated by fixture round-trip (tests/test_abc.py). The
Ogawa container layer itself (ogawa.py) is spec-exact."""

from __future__ import annotations

import struct
import sys

import numpy as np

from .ogawa import OgawaReader, OgawaWriter

# POD enum (Alembic PlainOldDataType)
POD_U8, POD_I8 = 1, 2
POD_U16, POD_I16 = 3, 4
POD_U32, POD_I32 = 5, 6
POD_U64, POD_I64 = 7, 8
POD_F16, POD_F32, POD_F64 = 9, 10, 11
POD_NP = {
    POD_U8: np.uint8, POD_I8: np.int8, POD_U16: np.uint16,
    POD_I16: np.int16, POD_U32: np.uint32, POD_I32: np.int32,
    POD_U64: np.uint64, POD_I64: np.int64, POD_F16: np.float16,
    POD_F32: np.float32, POD_F64: np.float64,
}
PTYPE_COMPOUND, PTYPE_SCALAR, PTYPE_ARRAY = 0, 1, 2


def _pack_info(ptype, pod=0, extent=0, size_hint=2, has_tsidx=False):
    return (
        (ptype & 3) | ((size_hint & 3) << 2) | ((pod & 15) << 4)
        | (int(has_tsidx) << 8) | ((extent & 255) << 12)
    )


def _unpack_info(info):
    return dict(
        ptype=info & 3,
        size_hint=(info >> 2) & 3,
        pod=(info >> 4) & 15,
        has_tsidx=bool((info >> 8) & 1),
        extent=(info >> 12) & 255,
    )


def _sh_fmt(size_hint):
    return {0: "<B", 1: "<H", 2: "<I"}[size_hint]


def _parse_name_meta(buf, o, indexed):
    (nsize,) = struct.unpack_from("<I", buf, o)
    o += 4
    name = bytes(buf[o:o + nsize]).decode()
    o += nsize
    mi = buf[o]
    o += 1
    if mi == 0xFF:
        (msize,) = struct.unpack_from("<I", buf, o)
        o += 4
        meta = bytes(buf[o:o + msize]).decode()
        o += msize
    else:
        meta = indexed[mi] if mi < len(indexed) else ""
    return name, meta, o


def _emit_name_meta(out, name, meta):
    nb = name.encode()
    out += struct.pack("<I", len(nb)) + nb
    if meta:
        mb = meta.encode()
        out += bytes([0xFF]) + struct.pack("<I", len(mb)) + mb
    else:
        out += bytes([0])
    return out


def _meta_dict(meta: str) -> dict:
    d = {}
    for part in meta.split(";"):
        if "=" in part:
            k, v = part.split("=", 1)
            d[k] = v
    return d


class _Prop:
    def __init__(self, reader, word, name, meta, info, nsamples):
        self._r = reader
        self._word = word
        self.name = name
        self.meta = meta
        self.info = info
        self.n_samples = nsamples

    @property
    def is_compound(self):
        return self.info["ptype"] == PTYPE_COMPOUND

    def children(self):
        assert self.is_compound
        return _read_props(self._r, self._word)

    def child(self, name):
        for p in self.children():
            if p.name == name:
                return p
        return None

    def sample(self, i: int) -> np.ndarray:
        """Array/scalar sample as np array [n, extent] (extent dim kept)."""
        info = self.info
        assert info["ptype"] in (PTYPE_SCALAR, PTYPE_ARRAY)
        words = self._r.group(self._word)
        i = min(i, self.n_samples - 1)  # clamp like Alembic's held samples
        w = words[2 * i] if info["ptype"] == PTYPE_ARRAY else words[i]
        raw = self._r.data(w)
        payload = raw[16:]  # skip the 16-B sample key digest
        dt = POD_NP[info["pod"]]
        flat = np.frombuffer(payload, dtype=dt)
        ext = max(info["extent"], 1)
        return flat.reshape(-1, ext)


def _read_props(reader, cpr_word):
    words = reader.group(cpr_word)
    if not words:
        return []
    hdr = reader.data(words[-1])
    props = []
    o = 0
    k = 0
    while o < len(hdr):
        (info_u32,) = struct.unpack_from("<I", hdr, o)
        o += 4
        info = _unpack_info(info_u32)
        nsamples = 0
        if info["ptype"] != PTYPE_COMPOUND:
            fmt = _sh_fmt(info["size_hint"])
            (nsamples,) = struct.unpack_from(fmt, hdr, o)
            o += struct.calcsize(fmt)
            if info["has_tsidx"]:
                o += struct.calcsize(fmt)  # time sampling index (0 assumed)
        name, meta, o = _parse_name_meta(hdr, o, reader.indexed_meta)
        props.append(_Prop(reader, words[k], name, meta, info, nsamples))
        k += 1
    return props


class _Object:
    def __init__(self, reader, word, name, meta):
        self._r = reader
        self._word = word
        self.name = name
        self.meta = meta
        self.schema = _meta_dict(meta).get("schema", "")

    def properties(self):
        words = self._r.group(self._word)
        if not words:
            return []
        return _read_props(self._r, words[0])

    def prop(self, name):
        for p in self.properties():
            if p.name == name:
                return p
        return None

    def children(self):
        words = self._r.group(self._word)
        if len(words) < 2:
            return []
        hdr = self._r.data(words[-1])
        out = []
        o = 0
        k = 1
        while o < len(hdr) and k <= len(words) - 2:
            name, meta, o = _parse_name_meta(hdr, o, self._r.indexed_meta)
            out.append(_Object(self._r, words[k], name, meta))
            k += 1
        return out


class AbcArchive:
    """Read side. Mirrors prlib AbcArchive::{open, readFlat} usage in the
    reference (RTCamp.cpp:78-109)."""

    def __init__(self, path: str):
        self._r = OgawaReader(path)
        root = self._r.group(self._r.root)
        if len(root) < 6:
            raise ValueError(f"{path}: not an Alembic-Ogawa archive")
        self.metadata = bytes(self._r.data(root[3])).decode()

        # indexed metadata strings (index 0 = "")
        imeta = [""]
        blob = self._r.data(root[5])
        o = 0
        while o < len(blob):
            n = blob[o]
            o += 1
            imeta.append(bytes(blob[o:o + n]).decode())
            o += n
        self._r.indexed_meta = imeta

        # time samplings
        ts = self._r.data(root[4])
        self.time_per_cycle = 1.0 / 24.0
        self.times = [0.0]
        self.max_sample = 1
        if len(ts) >= 16:
            (self.max_sample,) = struct.unpack_from("<I", ts, 0)
            (self.time_per_cycle,) = struct.unpack_from("<d", ts, 4)
            (npc,) = struct.unpack_from("<I", ts, 12)
            self.times = list(
                struct.unpack_from(f"<{npc}d", ts, 16)
            ) if npc else [0.0]

        self.top = _Object(self._r, root[2], "ABC", "")

    @property
    def n_frames(self) -> int:
        return max(self.max_sample, 1)

    def close(self):
        self._r.close()

    def _polymeshes(self):
        out = []

        def walk(obj):
            if "PolyMesh" in obj.schema:
                out.append(obj)
            else:
                if "Xform" in obj.schema:
                    xf = obj.prop(".xform")
                    if xf is not None and not xf.is_compound and \
                            xf.n_samples > 1:
                        print(
                            f"[abc] warning: animated Xform '{obj.name}' "
                            "treated as identity (bake transforms into P)",
                            file=sys.stderr,
                        )
                for c in obj.children():
                    walk(c)

        for c in self.top.children():
            walk(c)
        return out

    def read_flat(self, frame: int):
        """(verts f32[T,3,3], colors f32[T,3,3], emissions f32[T,3,3]) at
        `frame`, fan-triangulated like the reference requires triangles
        (voxUtil.hpp:40 asserts faceCounts==3; n-gons are fanned here)."""
        vs, cs, es = [], [], []
        for mesh in self._polymeshes():
            geom = mesh.prop(".geom")
            if geom is None:
                continue
            p_prop = geom.child("P")
            fi_prop = geom.child(".faceIndices")
            fc_prop = geom.child(".faceCounts")
            if p_prop is None or fi_prop is None or fc_prop is None:
                continue
            P = p_prop.sample(frame).astype(np.float32)          # [n, 3]
            idx = fi_prop.sample(frame)[:, 0].astype(np.int64)   # [ni]
            cnt = fc_prop.sample(frame)[:, 0].astype(np.int64)   # [nf]

            cd = emi = None
            arb = geom.child(".arbGeomParams")
            if arb is not None and arb.is_compound:
                for gp in arb.children():
                    vals = gp
                    if gp.is_compound:  # indexed GeomParam: <name>/.vals
                        vals = gp.child(".vals")
                        if vals is None:
                            continue
                    if gp.name == "Cd":
                        cd = vals.sample(frame).astype(np.float32)
                    elif gp.name == "Emission":
                        emi = vals.sample(frame).astype(np.float32)

            # fan-triangulate faces; per-POINT attribute lookup by index
            # (colorAttirb->get(index), voxUtil.hpp:46-49)
            tri_idx = []
            o = 0
            for c in cnt:
                for k in range(1, c - 1):
                    tri_idx.append((idx[o], idx[o + k], idx[o + k + 1]))
                o += c
            ti = np.asarray(tri_idx, np.int64).reshape(-1, 3)
            vs.append(P[ti])
            cs.append(
                cd[ti] if cd is not None and len(cd) == len(P)
                else np.ones((len(ti), 3, 3), np.float32)
            )
            es.append(
                emi[ti] if emi is not None and len(emi) == len(P)
                else np.zeros((len(ti), 3, 3), np.float32)
            )
        if not vs:
            z = np.zeros((0, 3, 3), np.float32)
            return z, z.copy(), z.copy()
        return (
            np.concatenate(vs), np.concatenate(cs), np.concatenate(es),
        )


# ---------------------------------------------------------------------------
# Fixture writer (same layout, write side)
# ---------------------------------------------------------------------------

def _sample_blob(arr: np.ndarray) -> bytes:
    payload = np.ascontiguousarray(arr).tobytes()
    # 16-B sample key: Alembic stores a murmur3-128 digest; any stable
    # 16 bytes satisfies readers that skip it (ours does)
    from .native import murmur3_32

    h = murmur3_32(payload) or (len(payload) & 0xFFFFFFFF)
    key = struct.pack("<IIII", h, len(payload) & 0xFFFFFFFF, 0, 0)
    return key + payload


def _prop_header(name, ptype, pod=0, extent=0, nsamples=0, meta=""):
    out = struct.pack("<I", _pack_info(ptype, pod, extent))
    if ptype != PTYPE_COMPOUND:
        out += struct.pack("<I", nsamples)
    return _emit_name_meta(bytearray(out), name, meta)


def _array_prop(name, samples, pod, extent, meta=""):
    """(group, header bytes) for an array property."""
    grp = []
    for s in samples:
        grp.append(_sample_blob(s))
        dims = np.asarray([len(s)], np.uint64)
        grp.append(dims.tobytes())
    hdr = _prop_header(
        name, PTYPE_ARRAY, pod, extent, nsamples=len(samples), meta=meta
    )
    return grp, bytes(hdr)


def _compound(children):
    """children: list of (group, header bytes) -> (group, None-header)."""
    grp = [g for g, _ in children]
    grp.append(b"".join(h for _, h in children))
    return grp


def write_fixture_abc(
    path: str, frames_verts, colors=None, emissions=None, fps: float = 24.0,
):
    """Write a PolyMesh-per-frame archive in the subset read_flat consumes.
    frames_verts: list of f32[T, 3, 3] triangle soups (topology may vary)."""
    n_frames = len(frames_verts)
    P_samples, fi_samples, fc_samples = [], [], []
    cd_samples, em_samples = [], []
    for f, tris in enumerate(frames_verts):
        tris = np.asarray(tris, np.float32).reshape(-1, 3, 3)
        nt = len(tris)
        P_samples.append(tris.reshape(-1, 3))
        fi_samples.append(np.arange(nt * 3, dtype=np.int32).reshape(-1, 1))
        fc_samples.append(np.full((nt, 1), 3, np.int32))
        if colors is not None:
            cd_samples.append(
                np.asarray(colors[f], np.float32).reshape(-1, 3)
            )
        if emissions is not None:
            em_samples.append(
                np.asarray(emissions[f], np.float32).reshape(-1, 3)
            )

    geom_children = [
        _array_prop("P", P_samples, POD_F32, 3,
                    meta="interpretation=point"),
        _array_prop(".faceIndices", fi_samples, POD_I32, 1),
        _array_prop(".faceCounts", fc_samples, POD_I32, 1),
    ]
    arb_children = []
    if cd_samples:
        arb_children.append(
            _array_prop("Cd", cd_samples, POD_F32, 3, meta="geoScope=var")
        )
    if em_samples:
        arb_children.append(
            _array_prop("Emission", em_samples, POD_F32, 3,
                        meta="geoScope=var")
        )
    if arb_children:
        arb_grp = _compound(arb_children)
        arb_hdr = _prop_header(".arbGeomParams", PTYPE_COMPOUND)
        geom_children.append((arb_grp, bytes(arb_hdr)))

    geom_grp = _compound(geom_children)
    geom_hdr = _prop_header(".geom", PTYPE_COMPOUND)
    mesh_props = _compound([(geom_grp, bytes(geom_hdr))])

    mesh_obj = [mesh_props, b""]  # [.prop group, child-headers blob (none)]
    top_children_hdr = _emit_name_meta(
        bytearray(), "mesh1", "schema=AbcGeom_PolyMesh_v1"
    )
    top_obj = [[], mesh_obj, bytes(top_children_hdr)]  # props, child, hdrs

    times = struct.pack(
        "<IdI", n_frames, 1.0 / fps, 1
    ) + struct.pack("<d", 0.0)
    root = [
        struct.pack("<i", 0),          # spec version
        struct.pack("<i", 10800),      # writer version
        top_obj,
        b"_ai_AlembicVersion=hako fixture writer",
        times,
        b"",                            # indexed metadata (none)
    ]
    OgawaWriter().write(path, root)
