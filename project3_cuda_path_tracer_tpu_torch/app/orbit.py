"""Spherical-orbit camera controls (the JAX app/orbit.py, reference parity:
src/main.cpp:60-67 derivation and src/main.cpp:102-120 rebuild, plus the
zoom/pan semantics of the mouse callbacks, src/main.cpp:169-205).

The reference binds these to GLFW mouse events; headless, they are driven
programmatically (or by the preview server's endpoints). Behavioral
contract preserved: ANY camera change resets progressive accumulation
(src/main.cpp:102 camchanged -> iteration = 0)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from ..scene import types as T


@dataclass
class OrbitState:
    """phi/theta/zoom around a look-at point (reference: src/main.h + the
    derivation in src/main.cpp:60-67)."""
    phi: float
    theta: float
    zoom: float
    look_at: np.ndarray
    up_sign: float = 1.0

    @staticmethod
    def from_camera(cam: T.Camera) -> "OrbitState":
        """Reference derivation (src/main.cpp:60-67): view = position -
        lookAt; zoom = |view|; phi/theta from the view direction."""
        view = np.asarray(cam.position, np.float64) - np.asarray(
            cam.look_at, np.float64)
        zoom = float(np.linalg.norm(view))
        view_n = view / zoom
        # position = lookAt + zoom*(sin(phi)sin(theta), cos(theta),
        #                            cos(phi)sin(theta))
        theta = float(np.arccos(np.clip(view_n[1], -1.0, 1.0)))
        phi = float(np.arctan2(view_n[0], view_n[2]))
        return OrbitState(phi=phi, theta=theta, zoom=zoom,
                          look_at=np.asarray(cam.look_at, np.float32).copy())

    def rotate(self, dphi: float, dtheta: float) -> "OrbitState":
        """Left-drag orbit; theta clamped to (0.001, pi)
        (reference: src/main.cpp:180-187)."""
        return dataclasses.replace(
            self, phi=self.phi + dphi,
            theta=float(np.clip(self.theta + dtheta, 0.001, np.pi - 0.001)))

    def dolly(self, dzoom: float) -> "OrbitState":
        """Right-drag zoom; min distance 0.1 (reference: src/main.cpp:189-192)."""
        return dataclasses.replace(self, zoom=max(self.zoom + dzoom, 0.1))

    def pan(self, dx: float, dy: float, cam: T.Camera) -> "OrbitState":
        """Middle-drag pan of lookAt in the ground plane
        (reference: src/main.cpp:194-204: moves along `forward` with y
        zeroed and `right`)."""
        forward = np.asarray(cam.view, np.float64).copy()
        forward[1] = 0.0
        n = np.linalg.norm(forward)
        if n > 0:
            forward /= n
        right = np.asarray(cam.right, np.float64).copy()
        right[1] = 0.0
        n = np.linalg.norm(right)
        if n > 0:
            right /= n
        la = (np.asarray(self.look_at, np.float64)
              - forward * dy + right * dx)
        return dataclasses.replace(self, look_at=la.astype(np.float32))

    def recenter(self) -> "OrbitState":
        """SPACE key: re-center lookAt at the origin
        (reference: src/main.cpp:161-166 resets to ogLookAt)."""
        return dataclasses.replace(
            self, look_at=np.zeros(3, np.float32))

    def apply(self, cam: T.Camera) -> T.Camera:
        """Rebuild the camera from the orbit state (reference:
        src/main.cpp:106-119): position = lookAt + zoom*dir(phi,theta),
        view toward lookAt, right/up re-orthogonalized against world-Y."""
        st, ct = np.sin(self.theta), np.cos(self.theta)
        sp, cp = np.sin(self.phi), np.cos(self.phi)
        direction = np.array([sp * st, ct, cp * st], np.float64)
        pos = np.asarray(self.look_at, np.float64) + self.zoom * direction
        cam.position = pos.astype(np.float32)
        cam.look_at = np.asarray(self.look_at, np.float32)
        cam.up = np.array([0.0, 1.0, 0.0], np.float32)
        return cam.derive()
