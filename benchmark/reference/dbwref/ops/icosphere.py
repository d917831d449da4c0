"""Host-side mesh topology builders (numpy).

Topology is STATIC in this framework — the icospheres, ground plane and cube
are built once at model init and never change during optimization (the key
structural simplification over the reference's PyTorch3D ``Meshes`` objects,
reference: src/model/dbw.py:74-96). Everything here runs on host in numpy and
returns plain float32/int32 arrays that become constants of the jitted
compute graph.

Replaces pytorch3d ``ico_sphere`` / ``SubdivideMeshes`` and the OBJ
primitives (reference: src/utils/mesh.py:104-124, 172-211,
primitives/plane.obj, primitives/cube.obj).
"""

import numpy as np

__all__ = ["icosphere", "subdivide", "plane_mesh", "cube_mesh", "flip_faces"]


def _icosahedron():
    """Canonical 12-vert icosahedron on the unit sphere (same vertex layout
    family as pytorch3d's ico_sphere level 0)."""
    t = (1.0 + 5.0**0.5) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int32,
    )
    return verts, faces


def subdivide(verts, faces, project_to_sphere=False):
    """One step of midpoint (Loop-topology) subdivision: each triangle ->
    4 triangles, midpoints deduplicated across shared edges.

    Equivalent of pytorch3d SubdivideMeshes (reference: src/model/dbw.py:78).
    """
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    edge_mid = {}
    new_verts = [v for v in verts]

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in edge_mid:
            m = (verts[a] + verts[b]) / 2.0
            if project_to_sphere:
                m = m / np.linalg.norm(m)
            edge_mid[key] = len(new_verts)
            new_verts.append(m)
        return edge_mid[key]

    new_faces = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
    return np.asarray(new_verts), np.asarray(new_faces, dtype=np.int32)


def icosphere(level=1, flip=False, dtype=np.float32):
    """Unit icosphere: level 0 = icosahedron (12v/20f); each level quadruples
    faces (level 1: 42v/80f, level 2: 162v/320f).

    `flip=True` reverses winding so faces point inward (the background dome,
    reference: src/utils/mesh.py:116-118, src/model/dbw.py:74)."""
    verts, faces = _icosahedron()
    for _ in range(level):
        verts, faces = subdivide(verts, faces, project_to_sphere=True)
    if flip:
        faces = flip_faces(faces)
    return verts.astype(dtype), faces.astype(np.int32)


def flip_faces(faces):
    return np.stack([faces[:, 2], faces[:, 1], faces[:, 0]], axis=-1)


def plane_mesh(dtype=np.float32):
    """Unit XZ plane, 4 verts / 2 tris, +Y normal — same geometry as the
    reference's primitives/plane.obj (y == 0, x/z in [-1, 1])."""
    verts = np.array(
        [[1, 0, -1], [1, 0, 1], [-1, 0, 1], [-1, 0, -1]], dtype=dtype
    )
    faces = np.array([[3, 1, 0], [3, 2, 1]], dtype=np.int32)
    return verts, faces


def cube_mesh(dtype=np.float32):
    """[-1,1]^3 cube, 8 verts / 12 tris, outward normals — same geometry as
    the reference's primitives/cube.obj."""
    verts = np.array(
        [
            [1, -1, -1], [1, -1, 1], [-1, -1, 1], [-1, -1, -1],
            [1, 1, -1], [1, 1, 1], [-1, 1, 1], [-1, 1, -1],
        ],
        dtype=dtype,
    )
    faces = np.array(
        [
            [1, 3, 0], [7, 5, 4], [4, 1, 0], [5, 2, 1], [2, 7, 3], [0, 7, 4],
            [1, 2, 3], [7, 6, 5], [4, 5, 1], [5, 6, 2], [2, 6, 7], [0, 3, 7],
        ],
        dtype=np.int32,
    )
    return verts, faces
