"""Math utilities: constants and transform builders.

A copy of project3_cuda_path_tracer_tpu/utils/math.py (pure NumPy; importing
it from the JAX package would import jax). Reference: src/utilities.h:12-26,
src/utilities.cpp:65-72. All transform construction happens on the host in
NumPy float32 so that the matrices match the JAX package's bit for bit.
"""
from __future__ import annotations

import numpy as np

# Constants (reference: src/utilities.h:12-15)
PI = 3.1415926535897932384626422832795028841971
TWO_PI = 6.2831853071795864769252867665590057683943
SQRT_OF_ONE_THIRD = 0.5773502691896257645091487805019574556476
EPSILON = 1e-5

# Surface offset used by getPointOnRay (reference: src/intersections.h:27-29)
RAY_EPS = 1e-4


def rotate_x(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def rotate_y(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = c, s
    m[2, 0], m[2, 2] = -s, c
    return m


def rotate_z(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1] = c, -s
    m[1, 0], m[1, 1] = s, c
    return m


def translate(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(v, dtype=np.float32)
    return m


def scale(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = np.asarray(v, dtype=np.float32)
    return m


def build_transformation_matrix(translation, rotation_deg, scale_v) -> np.ndarray:
    """T @ Rx @ Ry @ Rz @ S, rotations in degrees.

    Matches the composition order of the reference
    (src/utilities.cpp:65-72: translationMat * (Rx*Ry*Rz) * scaleMat).
    Returned as a row-vector-on-the-right (column-vector math) 4x4, i.e.
    world = M @ [x, y, z, 1]^T.
    """
    t = translate(translation)
    r = rotate_x(rotation_deg[0]) @ rotate_y(rotation_deg[1]) @ rotate_z(rotation_deg[2])
    s = scale(scale_v)
    return (t @ r @ s).astype(np.float32)


def inverse(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m.astype(np.float64)).astype(np.float32)


def inverse_transpose(m: np.ndarray) -> np.ndarray:
    """Matches glm::inverseTranspose (full 4x4 inverse-transpose)."""
    return np.linalg.inv(m.astype(np.float64)).T.astype(np.float32)


def normalize(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.float32)
    return v / np.linalg.norm(v)
