"""Headless 2-D rasterizer — the rendering layer (counterpart of
``mpe_tpu/render/raster.py``, the same code: it is numpy on the host and
draws the same pixels).

Capability parity with reference multiagent/rendering.py (a pyglet/OpenGL
immediate-mode renderer) without any GL/window dependency: the same
``Viewer`` / ``Geom`` / ``Transform`` / ``make_*`` surface
(rendering.py:45-317), drawing into a numpy RGB canvas with alpha
blending and anti-aliased edges. ``render(return_rgb_array=True)``
returns the frame like the reference's color-buffer readback
(rendering.py:98-109). Display is headless by default (frames can be
saved via ``SimpleImageViewer``); when a display exists (or
MPE_WINDOW=1) the Viewer mirrors frames into an optional matplotlib
window with real key events (render/window.py).

Pure NumPy on host — rendering is observability tooling, not a hot path;
the simulation stays on the device; a frame copies its positions to the
host once.
"""

from __future__ import annotations

import numpy as np


class Attr:
    def apply(self, pts: np.ndarray) -> np.ndarray:
        return pts


class Transform(Attr):
    """translation/rotation/scale attr (rendering.py:176-212)."""

    def __init__(self, translation=(0.0, 0.0), rotation=0.0, scale=(1.0, 1.0)):
        self.translation = np.asarray(translation, np.float64)
        self.rotation = float(rotation)
        self.scale = np.asarray(scale, np.float64)

    def set_translation(self, x, y):
        self.translation = np.array([x, y], np.float64)

    def set_rotation(self, rot):
        self.rotation = float(rot)

    def set_scale(self, sx, sy):
        self.scale = np.array([sx, sy], np.float64)

    def apply(self, pts):
        c, s = np.cos(self.rotation), np.sin(self.rotation)
        rot = np.array([[c, -s], [s, c]])
        return (pts * self.scale) @ rot.T + self.translation


class Color(Attr):
    def __init__(self, vec4):
        self.vec4 = vec4


class LineStyle(Attr):
    """Stipple-pattern attr (rendering.py:201-208): ``style`` is the
    16-bit GL_LINE_STIPPLE mask; line geoms skip samples whose pattern
    bit is 0."""

    def __init__(self, style: int):
        self.style = int(style)


class LineWidth(Attr):
    """Stroke-width attr (rendering.py:210-214): overrides the geom's
    own linewidth while attached, like glLineWidth state."""

    def __init__(self, stroke: float):
        self.stroke = float(stroke)


def _stroke_attrs(geom, default_width: float):
    """Effective (width, stipple pattern) for a line geom: the last
    LineWidth/LineStyle attr wins (GL state semantics — the reference
    enables attrs in reverse list order, rendering.py:160-166)."""
    width, pattern = default_width, 0xFFFF
    for a in geom.attrs:
        if isinstance(a, LineWidth):
            width = a.stroke
        elif isinstance(a, LineStyle):
            pattern = a.style
    return width, pattern


class Geom:
    """Base drawable (rendering.py:153-174)."""

    def __init__(self):
        self._color = Color((0.0, 0.0, 0.0, 1.0))
        self.attrs: list[Attr] = [self._color]

    def add_attr(self, attr: Attr):
        self.attrs.append(attr)
        return self

    def set_color(self, r, g, b, alpha=1.0):
        self._color.vec4 = (r, g, b, alpha)
        return self

    def _world_points(self, pts):
        for attr in self.attrs:
            pts = attr.apply(pts)
        return pts

    def draw(self, canvas: "Canvas"):
        raise NotImplementedError


class FilledPolygon(Geom):
    def __init__(self, points):
        super().__init__()
        self.points = np.asarray(points, np.float64)

    def draw(self, canvas):
        canvas.fill_polygon(self._world_points(self.points), self._color.vec4)


class PolyLine(Geom):
    def __init__(self, points, close: bool):
        super().__init__()
        self.points = np.asarray(points, np.float64)
        self.close = close
        self.linewidth = 1.0

    def set_linewidth(self, w):
        self.linewidth = float(w)
        return self

    def draw(self, canvas):
        pts = self._world_points(self.points)
        n = len(pts)
        width, pattern = _stroke_attrs(self, self.linewidth)
        rng = range(n) if self.close else range(n - 1)
        for i in rng:
            canvas.line(pts[i], pts[(i + 1) % n], self._color.vec4,
                        width, pattern)


class Line(Geom):
    def __init__(self, start=(0.0, 0.0), end=(0.0, 0.0)):
        super().__init__()
        self.start = np.asarray(start, np.float64)
        self.end = np.asarray(end, np.float64)
        self.linewidth = 1.0

    def draw(self, canvas):
        a, b = self._world_points(np.stack([self.start, self.end]))
        width, pattern = _stroke_attrs(self, self.linewidth)
        canvas.line(a, b, self._color.vec4, width, pattern)


class Point(Geom):
    """Single point at the transform origin (rendering.py:216-222)."""

    def draw(self, canvas):
        (p,) = self._world_points(np.zeros((1, 2)))
        canvas.point(p, self._color.vec4)


class Compound(Geom):
    """Group geom (rendering.py:269-276): children lose their own Color
    attrs and take the compound's color; the compound's attrs (e.g. a
    caller-added Transform) compose outside each child's own."""

    def __init__(self, gs):
        super().__init__()
        self.gs = list(gs)
        for g in self.gs:
            g.attrs = [a for a in g.attrs if not isinstance(a, Color)]
            g._color = self._color
    def draw(self, canvas):
        for g in self.gs:
            saved = g.attrs
            # child transforms apply first, then the compound's — the
            # reference enables compound attrs around child renders
            g.attrs = g.attrs + [a for a in self.attrs
                                 if not isinstance(a, Color)]
            try:
                g.draw(canvas)
            finally:
                g.attrs = saved


class Image(Geom):
    """Textured quad (rendering.py:306-317): an RGB array drawn into a
    (width, height) world rect centered at the transform origin."""

    def __init__(self, img: np.ndarray, width: float, height: float):
        super().__init__()
        self.img = np.asarray(img)
        self.width = float(width)
        self.height = float(height)

    def draw(self, canvas):
        corners = np.array(
            [[-self.width / 2, -self.height / 2],
             [self.width / 2, self.height / 2]])
        canvas.blit(self._world_points(corners), self.img)


# factory helpers (rendering.py:243-267)

def make_circle(radius: float = 10, res: int = 30, filled: bool = True):
    ang = np.linspace(0, 2 * np.pi, res, endpoint=False)
    points = np.stack([np.cos(ang), np.sin(ang)], axis=-1) * radius
    return FilledPolygon(points) if filled else PolyLine(points, True)


def make_polygon(v, filled: bool = True):
    return FilledPolygon(v) if filled else PolyLine(v, True)


def make_polyline(v):
    return PolyLine(v, False)


def make_capsule(length: float, width: float):
    """Box + two end circles grouped in a Compound — the reference's own
    construction (rendering.py:253-260)."""
    l, r, t, b = 0, length, width / 2, -width / 2
    box = make_polygon([(l, b), (l, t), (r, t), (r, b)])
    circ0 = make_circle(width / 2)
    circ1 = make_circle(width / 2)
    circ1.add_attr(Transform(translation=(length, 0)))
    return Compound([box, circ0, circ1])


def get_display(spec):
    """Display-spec resolver (rendering.py:32-43): ``None`` -> None, a
    string like ``':0'`` -> a Display handle (headless placeholder — no
    window system is driven), anything else -> ValueError."""
    if spec is None:
        return None
    if isinstance(spec, str):
        class Display:
            def __init__(self, name):
                self.name = name

            def __repr__(self):
                return f"Display({self.name!r})"

        return Display(spec)
    raise ValueError(
        f"Invalid display specification: {spec!r}. "
        "(Must be a string like :0 or None.)")


class Canvas:
    """Pixel buffer + world->pixel mapping with alpha blending."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.buf = np.ones((height, width, 3), np.float64)
        self.set_bounds(-1, 1, -1, 1)

    def set_bounds(self, left, right, bottom, top):
        self.left, self.right, self.bottom, self.top = left, right, bottom, top
        self.sx = self.width / (right - left)
        self.sy = self.height / (top - bottom)

    def to_px(self, pts):
        pts = np.asarray(pts, np.float64)
        x = (pts[..., 0] - self.left) * self.sx
        y = (self.top - pts[..., 1]) * self.sy
        return np.stack([x, y], axis=-1)

    def _blend(self, rows, cols, cov, color):
        r, g, b, a = color
        w = (cov * a)[:, None]
        self.buf[rows, cols] = self.buf[rows, cols] * (1 - w) + np.array(
            [r, g, b]) * w

    def fill_polygon(self, world_pts, color):
        pts = self.to_px(world_pts)                   # [V, 2] px
        x0 = max(int(np.floor(pts[:, 0].min())) - 1, 0)
        x1 = min(int(np.ceil(pts[:, 0].max())) + 1, self.width - 1)
        y0 = max(int(np.floor(pts[:, 1].min())) - 1, 0)
        y1 = min(int(np.ceil(pts[:, 1].max())) + 1, self.height - 1)
        if x1 < x0 or y1 < y0:
            return
        xs = np.arange(x0, x1 + 1) + 0.5
        ys = np.arange(y0, y1 + 1) + 0.5
        gx, gy = np.meshgrid(xs, ys)                  # [H', W']
        # even-odd rule, vectorized over all edges
        x_a, y_a = pts[:, 0], pts[:, 1]
        x_b, y_b = np.roll(x_a, -1), np.roll(y_a, -1)
        inside = np.zeros(gx.shape, bool)
        for k in range(len(pts)):
            cond = (y_a[k] > gy) != (y_b[k] > gy)
            denom = y_b[k] - y_a[k]
            if denom == 0:
                continue
            xint = x_a[k] + (gy - y_a[k]) / denom * (x_b[k] - x_a[k])
            inside ^= cond & (gx < xint)
        rows, cols = np.nonzero(inside)
        self._blend(rows + y0, cols + x0, np.ones(len(rows)), color)

    def point(self, p, color):
        """~1.5px dot (Point geom / GL_POINTS equivalent)."""
        px, py = self.to_px(p)
        r0, r1 = max(int(py) - 1, 0), min(int(py) + 1, self.height)
        c0, c1 = max(int(px) - 1, 0), min(int(px) + 1, self.width)
        if r1 > r0 and c1 > c0:
            rows, cols = np.mgrid[r0:r1, c0:c1]
            self._blend(rows.ravel(), cols.ravel(), np.ones(rows.size),
                        color)

    def line(self, a, b, color, width=1.0, pattern=0xFFFF):
        pa, pb = self.to_px(a), self.to_px(b)
        d = pb - pa
        length = np.hypot(*d)
        n = max(int(length * 2), 2)
        t = np.linspace(0, 1, n)[:, None]
        pts = pa + t * d
        half = max(width / 2, 0.5)
        for k, (px, py) in enumerate(pts):
            # GL_LINE_STIPPLE: the 16-bit mask advances one bit per pixel
            # (two samples per pixel here)
            if not (pattern >> ((k // 2) % 16)) & 1:
                continue
            r0, r1 = int(py - half), int(py + half) + 1
            c0, c1 = int(px - half), int(px + half) + 1
            r0, c0 = max(r0, 0), max(c0, 0)
            r1 = min(r1, self.height)
            c1 = min(c1, self.width)
            if r1 > r0 and c1 > c0:
                rows, cols = np.mgrid[r0:r1, c0:c1]
                self._blend(rows.ravel(), cols.ravel(),
                            np.ones(rows.size), color)

    def blit(self, world_corners, img):
        (x0, y0), (x1, y1) = self.to_px(world_corners)
        fc0, fc1 = int(min(x0, x1)), int(max(x0, x1))
        fr0, fr1 = int(min(y0, y1)), int(max(y0, y1))
        if fr1 <= fr0 or fc1 <= fc0:
            return
        c0, r0 = max(fc0, 0), max(fr0, 0)
        c1, r1 = min(fc1, self.width), min(fr1, self.height)
        if r1 <= r0 or c1 <= c0:
            return
        # sample the texture over the FULL destination rect, then keep
        # only the on-canvas rows/cols — a partially off-canvas image is
        # cropped (the reference's GL quad clips at the viewport), not
        # squashed into the visible sliver
        fh, fw = fr1 - fr0, fc1 - fc0
        ri = (np.arange(r0 - fr0, r1 - fr0) * img.shape[0] // fh)
        ci = (np.arange(c0 - fc0, c1 - fc0) * img.shape[1] // fw)
        patch = img[ri][:, ci, :3].astype(np.float64)
        if patch.max() > 1.0:
            patch = patch / 255.0
        self.buf[r0:r1, c0:c1] = patch

    def rgb_array(self) -> np.ndarray:
        return (np.clip(self.buf, 0, 1) * 255).astype(np.uint8)


class Viewer:
    """Drop-in for the reference Viewer (rendering.py:45-145).

    Headless by default; when a display is available (or MPE_WINDOW=1),
    an optional matplotlib window mirrors each rendered frame and feeds
    real key events to InteractivePolicy (render/window.py) — the
    reference's pyglet-window behavior (rendering.py:46-64)."""

    def __init__(self, width: int = 700, height: int = 700):
        self.canvas = Canvas(width, height)
        self.geoms: list[Geom] = []
        self.onetime_geoms: list[Geom] = []
        self.isopen = True
        # the live window opens LAZILY — on the first human-mode render
        # or when a key source asks for it — so pure rgb_array
        # pipelines (GIF export, benchmark loops) never pop a window or
        # pay per-frame canvas draws even when a display exists
        self._window = None
        self._window_tried = False

    def _ensure_window(self):
        if not self._window_tried:
            self._window_tried = True
            from mpe_tpu_torch.render import window as _window

            self._window = _window.open_window(self.canvas.width,
                                               self.canvas.height)
        return self._window

    def set_bounds(self, left, right, bottom, top):
        self.canvas.set_bounds(left, right, bottom, top)

    def add_geom(self, geom: Geom):
        self.geoms.append(geom)

    def add_onetime(self, geom: Geom):
        self.onetime_geoms.append(geom)

    # one-shot draw helpers (rendering.py:114-135)
    def draw_circle(self, radius=10, res=30, filled=True, **attrs):
        geom = make_circle(radius, res, filled)
        _add_attrs(geom, attrs)
        self.add_onetime(geom)
        return geom

    def draw_polygon(self, v, filled=True, **attrs):
        geom = make_polygon(v, filled)
        _add_attrs(geom, attrs)
        self.add_onetime(geom)
        return geom

    def draw_polyline(self, v, **attrs):
        geom = make_polyline(v)
        _add_attrs(geom, attrs)
        self.add_onetime(geom)
        return geom

    def draw_line(self, start, end, **attrs):
        geom = Line(start, end)
        _add_attrs(geom, attrs)
        self.add_onetime(geom)
        return geom

    def render(self, return_rgb_array: bool = False):
        self.canvas.buf[:] = 1.0
        for geom in self.geoms:
            geom.draw(self.canvas)
        for geom in self.onetime_geoms:
            geom.draw(self.canvas)
        self.onetime_geoms = []
        arr = self.canvas.rgb_array()
        window = (self._window if return_rgb_array
                  else self._ensure_window())
        if window is not None:
            window.imshow(arr)
            if not window.isopen:
                self.isopen = False
        return arr if return_rgb_array else self.isopen

    def close(self):
        self.isopen = False
        if self._window is not None:
            self._window.close()

    @property
    def window(self):  # keyboard-policy hook point (policy.py:21-22)
        return self._ensure_window()


def _add_attrs(geom, attrs):
    if "color" in attrs:
        geom.set_color(*attrs["color"])
    if "linewidth" in attrs and hasattr(geom, "set_linewidth"):
        geom.set_linewidth(attrs["linewidth"])


class SimpleImageViewer:
    """Headless stand-in for rendering.py:321-345: keeps the last frame
    and can save it to disk."""

    def __init__(self, display=None):
        self.last_frame = None
        self.isopen = False

    def imshow(self, arr: np.ndarray):
        self.last_frame = np.asarray(arr)
        self.isopen = True

    def save(self, path: str):
        from PIL import Image as PILImage

        PILImage.fromarray(self.last_frame).save(path)

    def close(self):
        self.isopen = False
