"""The benchmark's video, made from the run's seed (PyTorch, on the run's
device).

A camera that sways over a textured scene that ripples, while an object
crosses it, 4:2:0, with sensor noise drawn anew for every frame.  The scene is value
noise over several octaves (each octave a field of the seed's normals,
bicubically upsampled from one sample every `cell` pixels), with
sharp-edged regions cut where its coarsest octave crosses zero.  The
camera's offset follows two sines, so the motion is sub-pel and changes
from frame to frame; the scene ripples (a displacement that varies
across the frame and in time, as leaves, water or a crowd do, which no
one motion vector of a block predicts exactly); the object, a disc with
a texture of its own, moves
at its own sub-pel velocity and bounces off the frame's sides, so that
the frame holds local motion, occlusion and uncovered background.

Every parameter comes from the traffic mix's `video` object (see
`Video`); the seed draws only the textures and the noise, so every seed
gives the same sizes, the same motion and about the same detail, and the
work of an encode does not depend on it.  Frames are made in batches on
the device, each frame's noise from a generator of its own, so a frame
does not depend on which others are made with it; `frames()` gives them
all and `frame(i)` one, as (y, u, v) contiguous uint8 NumPy planes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

_GOLD = 0x9E3779B97F4A7C15
_MIX = 0xBF58476D1CE4E5B9


@dataclasses.dataclass(frozen=True)
class Video:
    """The scene and the camera.  octaves: (cell in pixels, amplitude)
    of each luma octave; edges: the step of the sharp-edged regions;
    chroma: the amplitude of the chroma planes relative to luma's;
    sway_px, sway_period: the camera offset's amplitude (x, y) in pixels
    and period (x, y) in frames; ripple_px, ripple_wavelength,
    ripple_period: the scene's ripple, its amplitude in pixels, its
    wavelength in pixels and its period in frames; object_radius: the disc's radius as a
    share of the frame's height; object_velocity: its velocity (x, y) in
    pixels a frame; noise: the sensor noise's standard deviation in luma
    levels (chroma: two thirds of it)."""
    octaves: tuple = ((96, 40.0), (24, 22.0), (6, 12.0), (2, 3.0))
    edges: float = 24.0
    chroma: float = 0.5
    sway_px: tuple = (40.0, 16.0)
    sway_period: tuple = (173.0, 131.0)
    ripple_px: float = 1.0
    ripple_wavelength: float = 96.0
    ripple_period: float = 30.0
    object_radius: float = 0.18
    object_velocity: tuple = (3.37, 1.61)
    noise: float = 2.0

    @classmethod
    def from_mix(cls, mix: dict) -> "Video":
        v = dict(mix.get("video", {}))
        for k in ("octaves",):
            if k in v:
                v[k] = tuple(tuple(o) for o in v[k])
        for k in ("sway_px", "sway_period", "object_velocity"):
            if k in v:
                v[k] = tuple(v[k])
        return cls(**v)


def _stream(seed: int, i: int) -> int:
    """The generator seed of stream i of a run's seed."""
    return (seed * _GOLD + (i + 1) * _MIX) % 2 ** 63


class Clip:
    """n frames of a w x h scene made by `video` from `seed` on `device`."""

    def __init__(self, seed: int, n: int, w: int, h: int,
                 video: Video | None = None, device="cpu"):
        import torch
        self.seed, self.n, self.w, self.h = seed, n, w, h
        self.video = video or Video()
        self.device = torch.device(device)
        v = self.video
        self.pad = pad = int(math.ceil(max(v.sway_px) + v.ripple_px)) + 4
        gen = self._gen(0)
        # the scene (luma), the object's texture, and the two chroma
        # planes of each, at luma resolution
        self.scene = self._texture(gen, h + 2 * pad, w + 2 * pad, 1.0, True)
        self.radius = r = v.object_radius * h
        side = int(2 * r) + 8
        self.obj = self._texture(gen, side, side, 1.0, True)
        self.scene_c = [self._texture(gen, h + 2 * pad, w + 2 * pad,
                                      v.chroma, False) for _ in range(2)]
        self.obj_c = [self._texture(gen, side, side, v.chroma, False)
                      for _ in range(2)]

    def _gen(self, i: int):
        import torch
        g = torch.Generator(device=self.device)
        g.manual_seed(_stream(self.seed, i))
        return g

    def _texture(self, gen, hh: int, ww: int, scale: float, edges: bool):
        import torch
        import torch.nn.functional as F
        v = self.video
        out = torch.zeros(hh, ww, device=self.device)
        coarse = None
        for cell, amp in v.octaves:
            gh, gw = hh // cell + 4, ww // cell + 4
            f = torch.randn(1, 1, gh, gw, generator=gen, device=self.device)
            up = F.interpolate(f, size=(gh * cell, gw * cell),
                               mode="bicubic", align_corners=False)
            up = up[0, 0, cell:cell + hh, cell:cell + ww]
            out += amp * scale * up
            if coarse is None:
                coarse = up
        if edges and v.edges:
            out += v.edges * scale * torch.sign(coarse)
        return out

    def _sway(self, i: int) -> tuple:
        v = self.video
        return tuple(a * math.sin(2 * math.pi * i / t)
                     for a, t in zip(v.sway_px, v.sway_period))

    def _centre(self, i: int) -> tuple:
        """The object's centre at frame i: a walk at its velocity that
        bounces off the frame's sides (a triangle wave)."""
        r = self.radius
        out = []
        for side, vel, start in ((self.w, self.video.object_velocity[0],
                                  0.3), (self.h, self.video.object_velocity[1],
                                         0.6)):
            span = max(side - 2 * r, 1.0)
            p = (start * span + vel * i) % (2 * span)
            out.append(r + (p if p <= span else 2 * span - p))
        return tuple(out)

    def _planes(self, idx: list, sub: int, scene, obj, noise):
        """Frames idx of one plane (luma: sub 1, chroma: sub 2) as a
        (len(idx), h / sub, w / sub) uint8 tensor; noise: its noise, one
        standard-normal field a frame."""
        import torch
        v, pad, dev = self.video, self.pad, self.device
        hh, ww = self.h // sub, self.w // sub
        k = len(idx)
        xs = (torch.arange(ww, device=dev, dtype=torch.float32) + 0.5) * sub
        ys = (torch.arange(hh, device=dev, dtype=torch.float32) + 0.5) * sub
        X, Y = xs.expand(k, hh, ww), ys[:, None].expand(k, hh, ww)
        t = torch.tensor([2 * math.pi * i / v.ripple_period for i in idx],
                         device=dev)[:, None, None]
        sway = torch.tensor([self._sway(i) for i in idx], device=dev)
        sx, sy = pad + sway[:, 0, None, None], pad + sway[:, 1, None, None]
        if v.ripple_px:
            q = 2 * math.pi / v.ripple_wavelength
            gx = X + sx + v.ripple_px * torch.sin(q * (Y + sy) + t)
            gy = Y + sy + v.ripple_px * torch.sin(q * (X + sx) * 0.8
                                                  + 0.7 * t + 1.0)
        else:
            gx, gy = X + sx, Y + sy
        img = self._sample(scene, gx, gy, k)
        if self.radius > 0:
            c = torch.tensor([self._centre(i) for i in idx], device=dev)
            cx, cy = c[:, 0, None, None], c[:, 1, None, None]
            side = obj.shape[0]
            # the object's texture moves with it
            tex = self._sample(obj, X - cx + side / 2, Y - cy + side / 2, k)
            d = torch.sqrt((X - cx) ** 2 + (Y - cy) ** 2)
            alpha = torch.clamp(self.radius - d + 0.5, 0.0, 1.0)
            img = img + alpha * (tex - img)
        return torch.clamp(torch.round(128.0 + img + noise), 0, 255
                           ).to(torch.uint8)

    @staticmethod
    def _sample(img, gx, gy, k: int):
        """img (a plane at luma resolution) at the positions (gx, gy),
        each (k, hh, ww) in img's pixels, bicubic."""
        import torch
        import torch.nn.functional as F
        H, W = img.shape
        grid = torch.stack((2 * gx / W - 1, 2 * gy / H - 1), -1)
        return F.grid_sample(img.expand(k, 1, H, W), grid, mode="bicubic",
                             padding_mode="border", align_corners=False)[:, 0]

    def batch(self, i0: int, i1: int) -> tuple:
        """Frames i0 .. i1 - 1 as (y, u, v) uint8 tensors on the clip's
        device, each (i1 - i0, rows, columns)."""
        import torch
        if not 0 <= i0 < i1 <= self.n:
            raise IndexError(f"frames {i0}..{i1 - 1} of a {self.n}-frame "
                             "clip")
        idx = list(range(i0, i1))
        h, w, s = self.h, self.w, self.video.noise
        noise = ([], [], [])
        for i in idx:
            g = self._gen(i + 1)
            for p, (hh, ww, sig) in enumerate(((h, w, s),
                                               (h // 2, w // 2, s * 2 / 3),
                                               (h // 2, w // 2, s * 2 / 3))):
                noise[p].append(sig * torch.randn(hh, ww, generator=g,
                                                  device=self.device))
        return (self._planes(idx, 1, self.scene, self.obj,
                             torch.stack(noise[0])),
                self._planes(idx, 2, self.scene_c[0], self.obj_c[0],
                             torch.stack(noise[1])),
                self._planes(idx, 2, self.scene_c[1], self.obj_c[1],
                             torch.stack(noise[2])))

    def frames(self, chunk: int = 16) -> list:
        """Every frame, made `chunk` at a time."""
        out = []
        for i0 in range(0, self.n, chunk):
            planes = [p.cpu().numpy() for p in
                      self.batch(i0, min(self.n, i0 + chunk))]
            out += [tuple(p[k] for p in planes)
                    for k in range(planes[0].shape[0])]
        return out

    def frame(self, i: int) -> tuple:
        if not 0 <= i < self.n:
            raise IndexError(f"frame {i} of a {self.n}-frame clip")
        return tuple(p[0].cpu().numpy() for p in self.batch(i, i + 1))

