"""Procedural test scenes, emitted as OBJ/MTL/.lights *text*.

The reference shipped curated manual-QA scenes (``resources/models/testing/``
— Cornell-box variants with mirror/diffuse/transparent materials and orb
lights, SURVEY.md §4). We generate equivalents procedurally and feed them
through the real parsers, so every golden test also exercises the I/O layer.
Materials carry both Schlick (rough/p) and Shirley-Ashikhmin (nu/nv/Rs/Rd)
parameters so either BRDF renders the same geometry.
"""

from __future__ import annotations

from typing import List, Tuple


def _box_faces(lines: List[str], vbase: int) -> None:
    """Quads of a unit-indexed 8-vertex box, as 12 triangles (1-based,
    relative to vbase)."""
    quads = [
        (1, 2, 3, 4),  # bottom  (y-)
        (5, 8, 7, 6),  # top     (y+)
        (1, 5, 6, 2),  # z-
        (4, 3, 7, 8),  # z+
        (1, 4, 8, 5),  # x-
        (2, 6, 7, 3),  # x+
    ]
    for a, b, c, d in quads:
        lines.append(f"f {vbase + a} {vbase + b} {vbase + c}")
        lines.append(f"f {vbase + a} {vbase + c} {vbase + d}")


def _box_vertices(lines: List[str], x0, y0, z0, x1, y1, z1) -> None:
    for x, y, z in [
        (x0, y0, z0),
        (x1, y0, z0),
        (x1, y0, z1),
        (x0, y0, z1),
        (x0, y1, z0),
        (x1, y1, z0),
        (x1, y1, z1),
        (x0, y1, z1),
    ]:
        lines.append(f"v {x} {y} {z}")


def cornell_box() -> Tuple[str, str, str]:
    """Cornell-box-style scene: open-front box (white floor/ceiling/back,
    red left, green right), a tall glossy block and a short diffuse block,
    one orb light, and a ``sky_light`` material for the miss color.

    Returns ``(obj_text, mtl_text, lights_text)``.
    """
    mtl = """
# Cornell materials — Schlick and Shirley-Ashikhmin parameter sets.
newmtl white
Kd 0.736 0.735 0.729
Ks 1.0 1.0 1.0
rough 1.0
p 1.0
nu 0
nv 0
Rs 0.0
Rd 1.0

newmtl red
Kd 0.611 0.056 0.062
Ks 1.0 1.0 1.0
rough 1.0
p 1.0
nu 0
nv 0
Rs 0.0
Rd 1.0

newmtl green
Kd 0.117 0.435 0.115
Ks 1.0 1.0 1.0
rough 1.0
p 1.0
nu 0
nv 0
Rs 0.0
Rd 1.0

newmtl glossy
Kd 0.3 0.3 0.35
Ks 0.9 0.9 0.9
rough 0.15
p 1.0
nu 120
nv 120
Rs 0.6
Rd 0.4

newmtl sky_light
Kd 0.85 0.9 1.0
""".strip()

    lights = """
newlight orb1
type 2
pos 0.0 1.85 0.0
radius 0.02
rgb 6.0 6.0 6.0
""".strip()

    lines: List[str] = ["# procedural cornell box", "o cornell"]
    # Outer shell vertices: x in [-1,1], y in [0,2], z in [-1,1].
    shell = [
        (-1, 0, -1),
        (1, 0, -1),
        (1, 0, 1),
        (-1, 0, 1),  # floor ring (y=0)
        (-1, 2, -1),
        (1, 2, -1),
        (1, 2, 1),
        (-1, 2, 1),  # ceiling ring (y=2)
    ]
    for x, y, z in shell:
        lines.append(f"v {x} {y} {z}")
    # floor (1..4), ceiling (5..8), back wall z=-1, left x=-1, right x=+1.
    lines.append("usemtl white")
    lines.append("f 1 2 3")
    lines.append("f 1 3 4")
    lines.append("f 5 7 6")
    lines.append("f 5 8 7")
    lines.append("f 1 5 6")  # back wall z=-1
    lines.append("f 1 6 2")
    lines.append("usemtl red")
    lines.append("f 1 4 8")  # left wall x=-1
    lines.append("f 1 8 5")
    lines.append("usemtl green")
    lines.append("f 2 6 7")  # right wall x=+1
    lines.append("f 2 7 3")

    # Short diffuse block.
    lines.append("usemtl white")
    vbase = 8
    _box_vertices(lines, 0.05, 0.0, 0.0, 0.75, 0.6, 0.65)
    _box_faces(lines, vbase)
    vbase += 8

    # Tall glossy block.
    lines.append("usemtl glossy")
    _box_vertices(lines, -0.75, 0.0, -0.65, -0.15, 1.2, -0.05)
    _box_faces(lines, vbase)

    return "\n".join(lines) + "\n", mtl + "\n", lights + "\n"


def single_triangle() -> Tuple[str, str, str]:
    """Milestone-1 scene (BASELINE.json configs[0]): one diffuse triangle in
    front of the camera, no lights, white sky."""
    obj = """
o tri
v -1.0 0.0 -1.0
v 1.0 0.0 -1.0
v 0.0 1.5 -1.0
usemtl grey
f 1 2 3
""".strip()
    mtl = """
newmtl grey
Kd 0.5 0.6 0.7
Ks 1.0 1.0 1.0
rough 1.0
p 1.0
nu 0
nv 0
Rs 0.0
Rd 1.0
""".strip()
    return obj + "\n", mtl + "\n", ""


def random_soup(n: int, seed: int = 0, extent: float = 1.0) -> str:
    """N random triangles in a cube — BVH stress geometry (the analog of the
    reference's larger squirrel test models)."""
    import numpy as np

    r = np.random.RandomState(seed)
    centers = r.uniform(-extent, extent, size=(n, 3))
    offs = r.uniform(-0.08, 0.08, size=(n, 3, 2, 3)).sum(axis=2)
    lines = ["o soup"]
    for i in range(n):
        for k in range(3):
            v = centers[i] + offs[i, k]
            lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
        lines.append(f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}")
    return "\n".join(lines) + "\n"

def multi_room(
    nx: int = 3, nz: int = 3, clutter: int = 10, seed: int = 0
) -> Tuple[str, str, str]:
    """Synthetic multi-room interior: an ``nx`` x ``nz`` grid of connected
    rooms (thin-box walls with door gaps), floor + ceiling, and ``clutter``
    diffuse boxes per room — the structured scene class with REAL spatial
    separation that the reference's testing set exercises (pillars /
    squirrels layouts) and that the round-4 culling ceiling claim was
    never measured on (VERDICT r4 item 3). The front (camera-facing, +z)
    side is open; one orb light sits in the front-center room.

    Returns ``(obj_text, mtl_text, lights_text)``.
    """
    import numpy as np

    room = 2.0  # room edge (x and z), wall height 2, thickness 0.06
    th = 0.06
    door = 0.8
    W, D = nx * room, nz * room
    x0, z1 = -W / 2.0, 1.0  # grid spans x0..x0+W, z1-D..z1 (front at z1)
    z0 = z1 - D
    r = np.random.RandomState(seed)

    lines: List[str] = ["o rooms", "usemtl wall"]
    nv = 0

    def box(xa, ya, za, xb, yb, zb):
        nonlocal nv
        _box_vertices(lines, xa, ya, za, xb, yb, zb)
        _box_faces(lines, nv)
        nv += 8

    # Floor and ceiling slabs.
    box(x0, -0.1, z0, x0 + W, 0.0, z1)
    box(x0, 2.0, z0, x0 + W, 2.1, z1)
    # Perimeter walls (front +z side open toward the camera).
    box(x0 - th, 0.0, z0 - th, x0 + W + th, 2.0, z0)          # back
    box(x0 - th, 0.0, z0, x0, 2.0, z1)                        # left
    box(x0 + W, 0.0, z0, x0 + W + th, 2.0, z1)                # right
    # Internal walls with centered door gaps.
    for i in range(1, nx):  # walls normal to x
        x = x0 + i * room
        for j in range(nz):
            za, zb = z0 + j * room, z0 + (j + 1) * room
            zm = (za + zb) / 2.0
            box(x - th / 2, 0.0, za, x + th / 2, 2.0, zm - door / 2)
            box(x - th / 2, 0.0, zm + door / 2, x + th / 2, 2.0, zb)
    for j in range(1, nz):  # walls normal to z
        z = z0 + j * room
        for i in range(nx):
            xa, xb = x0 + i * room, x0 + (i + 1) * room
            xm = (xa + xb) / 2.0
            box(xa, 0.0, z - th / 2, xm - door / 2, 2.0, z + th / 2)
            box(xm + door / 2, 0.0, z - th / 2, xb, 2.0, z + th / 2)
    # Clutter boxes per room.
    lines.append("usemtl prop")
    for i in range(nx):
        for j in range(nz):
            for _ in range(clutter):
                cx = x0 + i * room + r.uniform(0.25, room - 0.25)
                cz = z0 + j * room + r.uniform(0.25, room - 0.25)
                s = r.uniform(0.08, 0.28)
                h = r.uniform(0.15, 0.9)
                box(cx - s, 0.0, cz - s, cx + s, h, cz + s)

    mtl = (
        "newmtl wall\nKd 0.72 0.71 0.68\nKs 1.0 1.0 1.0\nrough 1.0\np 1.0\n"
        "nu 0\nnv 0\nRs 0.03\nRd 0.97\n"
        "newmtl prop\nKd 0.55 0.35 0.25\nKs 1.0 1.0 1.0\nrough 1.0\np 1.0\n"
        "nu 0\nnv 0\nRs 0.05\nRd 0.95\n"
    )
    li = (
        "newlight orb\ntype 2\nrgb 1.7 1.6 1.5\n"
        f"pos 0.0 1.75 {z1 - room / 2.0:.3f}\nradius 0.1\n"
    )
    return "\n".join(lines) + "\n", mtl, li


def grey_soup(n: int, seed: int = 11) -> Tuple[str, str, str]:
    """bench.py's ``--scene soup:<n>`` (bench.py:134-154): ``random_soup(n,
    seed)`` in one grey material, lit by an orb at (0, 2.4, 0) of radius
    0.09. Returns (obj, mtl, lights) text; the camera bench.py pairs with
    it looks along +z from (0, 0, 3.5)."""
    mtl = (
        "newmtl grey\nKd 0.62 0.62 0.62\nKs 1.0 1.0 1.0\nrough 1.0\np 1.0\n"
        "nu 0\nnv 0\nRs 0.05\nRd 0.95\n"
    )
    li = "newlight orb\ntype 2\nrgb 1.6 1.5 1.4\npos 0.0 2.4 0.0\nradius 0.09\n"
    obj = random_soup(n, seed=seed).replace("o soup\n", "o soup\nusemtl grey\n", 1)
    return obj, mtl, li


def cornell_sphere(rings: int = 12, segments: int = 24, center=(-0.45, 0.3, 0.45),
                   radius: float = 0.3):
    """The Cornell box with every face given its flat normal as ``vn``, and
    a smooth UV sphere (``segments`` x ``rings``: 528 faces, radial vertex
    normals) on the floor: (obj, mtl, lights) text, the Phong scenes of
    chip_smoke.py and ``tools/k9_walk.py``. A mesh keeps its vertex normals
    only when every face has them."""
    import numpy as np

    obj, mtl, lights = cornell_box()
    verts = [[float(c) for c in ln.split()[1:4]] for ln in obj.splitlines()
             if ln.startswith("v ")]
    out, normals = [], []
    for ln in obj.splitlines():
        if ln.startswith("f "):
            a, b, c = (int(i) - 1 for i in ln.split()[1:4])
            p = np.array([verts[a], verts[b], verts[c]])
            n = np.cross(p[1] - p[0], p[2] - p[0])
            normals.append(n / np.linalg.norm(n))
            k = len(normals)
            out.append(f"f {a + 1}//{k} {b + 1}//{k} {c + 1}//{k}")
        else:
            out.append(ln)
    out += [f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}" for n in normals]
    base_v, base_n = len(verts), len(normals)
    dirs = [(0.0, 1.0, 0.0)]
    for j in range(1, rings):
        th = np.pi * j / rings
        dirs += [(np.sin(th) * np.cos(2 * np.pi * i / segments), np.cos(th),
                  np.sin(th) * np.sin(2 * np.pi * i / segments)) for i in range(segments)]
    dirs.append((0.0, -1.0, 0.0))
    out.append("usemtl white")
    for x, y, z in dirs:
        out.append(f"v {center[0] + radius * x:.6f} {center[1] + radius * y:.6f} "
                   f"{center[2] + radius * z:.6f}")
        out.append(f"vn {x:.6f} {y:.6f} {z:.6f}")
    idx = lambda k: f"{base_v + k + 1}//{base_n + k + 1}"  # noqa: E731
    ring = lambda j, i: 1 + (j - 1) * segments + i % segments  # noqa: E731
    last = len(dirs) - 1
    for i in range(segments):
        out.append(f"f {idx(0)} {idx(ring(1, i + 1))} {idx(ring(1, i))}")
        out.append(f"f {idx(last)} {idx(ring(rings - 1, i))} {idx(ring(rings - 1, i + 1))}")
        for j in range(1, rings - 1):
            a, b, c, d = ring(j, i), ring(j, i + 1), ring(j + 1, i + 1), ring(j + 1, i)
            out.append(f"f {idx(a)} {idx(b)} {idx(c)}")
            out.append(f"f {idx(a)} {idx(c)} {idx(d)}")
    return "\n".join(out) + "\n", mtl, lights
