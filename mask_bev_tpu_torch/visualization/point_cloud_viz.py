"""OpenGL point-cloud viewer (interactive glfw window or headless EGL).

The port's own copy of ``mask_bev_tpu/visualization/point_cloud_viz.py``
and its ``shaders/`` (numpy and OpenGL; no tensor code). PyOpenGL, EGL and
glfw are imported inside the functions that draw, so the module imports
where they are missing (the card's machine has none); the camera matrices
and box wireframes need numpy only.

Counterpart of the reference viewer (``/root/reference/mask_bev/
visualization/point_cloud_viz.py`` + ``visualization/shaders/*``): GLSL
shader pipeline with per-point label colors / intensity grayscale, rotated
BEV box wireframes, and orbit camera. Two front doors:

  * :func:`show_point_cloud` — interactive glfw window (needs a display):
    drag to orbit, scroll to zoom, ``c`` toggles intensity/label coloring.
  * :func:`render_point_cloud` — HEADLESS offscreen render to a numpy RGB
    image via Mesa surfaceless EGL (works with no display at all; the
    reference viewer cannot run headless). Used by the tests.

Camera matrices are computed in numpy (no glm dependency).
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Optional, Tuple

import numpy as np

_SHADER_DIR = pathlib.Path(__file__).parent / "shaders"

# EGL_PLATFORM_SURFACELESS_MESA (EGL_MESA_platform_surfaceless)
_EGL_PLATFORM_SURFACELESS_MESA = 0x31DD

# default label palette (RGB in [0,1]); label 0 = unlabeled gray
_PALETTE = np.array([
    [0.6, 0.6, 0.6], [0.12, 0.47, 0.71], [1.00, 0.50, 0.05],
    [0.17, 0.63, 0.17], [0.84, 0.15, 0.16], [0.58, 0.40, 0.74],
    [0.55, 0.34, 0.29], [0.89, 0.47, 0.76], [0.74, 0.74, 0.13],
    [0.09, 0.75, 0.81],
], np.float32)


def label_colors(labels: np.ndarray) -> np.ndarray:
    """(N,) int labels -> (N, 3) float32 RGB from the cyclic palette."""
    return _PALETTE[np.asarray(labels, np.int64) % len(_PALETTE)]


# --- camera math (numpy; column-major upload via transpose) ---

def perspective(fov_y: float, aspect: float, near: float, far: float):
    f = 1.0 / np.tan(fov_y / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def look_at(eye, center, up):
    eye, center, up = (np.asarray(v, np.float32) for v in (eye, center, up))
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    u = np.cross(right, fwd)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = right, u, -fwd
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def orbit_eye(center, distance: float, azimuth: float, elevation: float):
    ce = np.cos(elevation)
    off = np.array([ce * np.cos(azimuth), ce * np.sin(azimuth),
                    np.sin(elevation)], np.float32)
    return np.asarray(center, np.float32) + distance * off


def box_wireframe(boxes: np.ndarray, z0: float = -1.5, z1: float = 1.0):
    """(M, 5) BEV boxes (cx, cy, w, l, yaw) -> line-list vertices (M*24, 3).

    12 edges per box (bottom/top rectangles at z0/z1 + 4 verticals).
    7-DoF boxes (x, y, z, w, l, h, yaw) are also accepted.
    """
    boxes = np.asarray(boxes, np.float32).reshape(-1, boxes.shape[-1])
    out = []
    for bx in boxes:
        if bx.shape[0] >= 7:
            cx, cy, cz, w, l, h, yaw = bx[:7]
            zb, zt = cz - h / 2, cz + h / 2
        else:
            cx, cy, w, l, yaw = bx[:5]
            zb, zt = z0, z1
        c, s = np.cos(yaw), np.sin(yaw)
        dx, dy = l / 2, w / 2
        corners = np.array([[dx, dy], [-dx, dy], [-dx, -dy], [dx, -dy]])
        corners = corners @ np.array([[c, s], [-s, c]], np.float32)
        corners += [cx, cy]
        bot = np.concatenate([corners, np.full((4, 1), zb)], 1)
        top = np.concatenate([corners, np.full((4, 1), zt)], 1)
        for ring in (bot, top):
            for i in range(4):
                out += [ring[i], ring[(i + 1) % 4]]
        for i in range(4):
            out += [bot[i], top[i]]
    return (np.asarray(out, np.float32) if out
            else np.zeros((0, 3), np.float32))


# --- GL plumbing ---

def _compile_program(gl, vert_src: str, frag_src: str):
    def shader(src, kind):
        sh = gl.glCreateShader(kind)
        gl.glShaderSource(sh, src)
        gl.glCompileShader(sh)
        if not gl.glGetShaderiv(sh, gl.GL_COMPILE_STATUS):
            raise RuntimeError(gl.glGetShaderInfoLog(sh).decode())
        return sh

    vs = shader(vert_src, gl.GL_VERTEX_SHADER)
    fs = shader(frag_src, gl.GL_FRAGMENT_SHADER)
    prog = gl.glCreateProgram()
    gl.glAttachShader(prog, vs)
    gl.glAttachShader(prog, fs)
    gl.glLinkProgram(prog)
    if not gl.glGetProgramiv(prog, gl.GL_LINK_STATUS):
        raise RuntimeError(gl.glGetProgramInfoLog(prog).decode())
    gl.glDeleteShader(vs)
    gl.glDeleteShader(fs)
    return prog


def _load_programs(gl):
    pv = (_SHADER_DIR / "point_vertex.vert").read_text()
    pf = (_SHADER_DIR / "point_fragment.frag").read_text()
    bv = (_SHADER_DIR / "box_vertex.vert").read_text()
    bf = (_SHADER_DIR / "box_fragment.frag").read_text()
    return _compile_program(gl, pv, pf), _compile_program(gl, bv, bf)


class _EglContext:
    """Headless Mesa surfaceless-EGL GL context (no display required)."""

    def __init__(self):
        import os
        os.environ.setdefault("PYOPENGL_PLATFORM", "egl")
        from OpenGL import EGL

        self.egl = EGL
        dpy = EGL.eglGetPlatformDisplay(
            _EGL_PLATFORM_SURFACELESS_MESA, EGL.EGL_DEFAULT_DISPLAY, None)
        maj, mnr = EGL.EGLint(), EGL.EGLint()
        if not EGL.eglInitialize(dpy, maj, mnr):
            raise RuntimeError("eglInitialize failed (no surfaceless Mesa)")
        EGL.eglBindAPI(EGL.EGL_OPENGL_API)
        attrs = (EGL.EGLint * 5)(
            EGL.EGL_SURFACE_TYPE, EGL.EGL_PBUFFER_BIT,
            EGL.EGL_RENDERABLE_TYPE, EGL.EGL_OPENGL_BIT, EGL.EGL_NONE)
        from OpenGL.EGL import EGLConfig
        cfgs = (EGLConfig * 1)()
        n = EGL.EGLint()
        if not EGL.eglChooseConfig(dpy, attrs, cfgs, 1, n) or n.value < 1:
            raise RuntimeError("eglChooseConfig failed")
        ctx = EGL.eglCreateContext(dpy, cfgs[0], EGL.EGL_NO_CONTEXT, None)
        if not ctx:
            raise RuntimeError("eglCreateContext failed")
        if not EGL.eglMakeCurrent(dpy, EGL.EGL_NO_SURFACE,
                                  EGL.EGL_NO_SURFACE, ctx):
            raise RuntimeError("eglMakeCurrent failed")
        self.dpy, self.ctx = dpy, ctx

    def close(self):
        e = self.egl
        e.eglMakeCurrent(self.dpy, e.EGL_NO_SURFACE, e.EGL_NO_SURFACE,
                         e.EGL_NO_CONTEXT)
        e.eglDestroyContext(self.dpy, self.ctx)
        e.eglTerminate(self.dpy)


def _upload_scene(gl, points, colors, boxes):
    pts = np.asarray(points, np.float32)
    if pts.shape[1] == 3:
        pts = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1)
    inter = np.concatenate([pts[:, :4], colors.astype(np.float32)], 1)
    inter = np.ascontiguousarray(inter, np.float32)

    vao = gl.glGenVertexArrays(1)
    gl.glBindVertexArray(vao)
    vbo = gl.glGenBuffers(1)
    gl.glBindBuffer(gl.GL_ARRAY_BUFFER, vbo)
    gl.glBufferData(gl.GL_ARRAY_BUFFER, inter.nbytes, inter,
                    gl.GL_STATIC_DRAW)
    stride = 7 * 4
    gl.glVertexAttribPointer(0, 4, gl.GL_FLOAT, gl.GL_FALSE, stride,
                             ctypes.c_void_p(0))
    gl.glEnableVertexAttribArray(0)
    gl.glVertexAttribPointer(1, 3, gl.GL_FLOAT, gl.GL_FALSE, stride,
                             ctypes.c_void_p(16))
    gl.glEnableVertexAttribArray(1)

    box_verts = (box_wireframe(boxes) if boxes is not None and len(boxes)
                 else np.zeros((0, 3), np.float32))
    bvao = gl.glGenVertexArrays(1)
    gl.glBindVertexArray(bvao)
    bvbo = gl.glGenBuffers(1)
    gl.glBindBuffer(gl.GL_ARRAY_BUFFER, bvbo)
    gl.glBufferData(gl.GL_ARRAY_BUFFER, max(box_verts.nbytes, 4), box_verts,
                    gl.GL_STATIC_DRAW)
    gl.glVertexAttribPointer(0, 3, gl.GL_FLOAT, gl.GL_FALSE, 12,
                             ctypes.c_void_p(0))
    gl.glEnableVertexAttribArray(0)
    return vao, len(inter), bvao, len(box_verts)


def _draw(gl, progs, scene, proj, view, *, point_size, render_mode,
          box_color=(0.1, 0.9, 0.2)):
    point_prog, box_prog = progs
    vao, npts, bvao, nbox = scene
    model = np.eye(4, dtype=np.float32)
    gl.glEnable(gl.GL_DEPTH_TEST)
    gl.glEnable(gl.GL_PROGRAM_POINT_SIZE)
    gl.glClearColor(0.0, 0.0, 0.0, 1.0)
    gl.glClear(gl.GL_COLOR_BUFFER_BIT | gl.GL_DEPTH_BUFFER_BIT)

    def set_mats(prog):
        gl.glUseProgram(prog)
        for name, m in (("u_proj", proj), ("u_view", view),
                        ("u_model", model)):
            loc = gl.glGetUniformLocation(prog, name)
            gl.glUniformMatrix4fv(loc, 1, gl.GL_TRUE, m)  # row-major + transpose

    set_mats(point_prog)
    gl.glUniform1f(gl.glGetUniformLocation(point_prog, "u_point_size"),
                   float(point_size))
    gl.glUniform1f(gl.glGetUniformLocation(point_prog, "u_render_mode"),
                   float(render_mode))
    gl.glBindVertexArray(vao)
    gl.glDrawArrays(gl.GL_POINTS, 0, npts)

    if nbox:
        set_mats(box_prog)
        gl.glUniform3f(gl.glGetUniformLocation(box_prog, "u_box_color"),
                       *box_color)
        gl.glBindVertexArray(bvao)
        gl.glDrawArrays(gl.GL_LINES, 0, nbox)


def render_point_cloud(
    points: np.ndarray,
    labels: Optional[np.ndarray] = None,
    boxes: Optional[np.ndarray] = None,
    *,
    size: Tuple[int, int] = (800, 600),
    point_size: float = 2.0,
    camera_distance: float = 60.0,
    azimuth: float = -np.pi / 2,
    elevation: float = np.pi / 4,
    center=(0.0, 0.0, 0.0),
    render_mode: Optional[int] = None,
) -> np.ndarray:
    """Headless render -> (H, W, 3) uint8 image (surfaceless EGL + FBO)."""
    # the EGL context must select the PyOpenGL platform BEFORE any
    # ``OpenGL.GL`` import resolves function pointers (GLX would need X11)
    w, h = size
    ctx = _EglContext()
    from OpenGL import GL as gl
    try:
        # offscreen framebuffer (surfaceless EGL has no default surface)
        fbo = gl.glGenFramebuffers(1)
        gl.glBindFramebuffer(gl.GL_FRAMEBUFFER, fbo)
        color = gl.glGenRenderbuffers(1)
        gl.glBindRenderbuffer(gl.GL_RENDERBUFFER, color)
        gl.glRenderbufferStorage(gl.GL_RENDERBUFFER, gl.GL_RGBA8, w, h)
        gl.glFramebufferRenderbuffer(gl.GL_FRAMEBUFFER,
                                     gl.GL_COLOR_ATTACHMENT0,
                                     gl.GL_RENDERBUFFER, color)
        depth = gl.glGenRenderbuffers(1)
        gl.glBindRenderbuffer(gl.GL_RENDERBUFFER, depth)
        gl.glRenderbufferStorage(gl.GL_RENDERBUFFER,
                                 gl.GL_DEPTH_COMPONENT24, w, h)
        gl.glFramebufferRenderbuffer(gl.GL_FRAMEBUFFER,
                                     gl.GL_DEPTH_ATTACHMENT,
                                     gl.GL_RENDERBUFFER, depth)
        assert (gl.glCheckFramebufferStatus(gl.GL_FRAMEBUFFER)
                == gl.GL_FRAMEBUFFER_COMPLETE)
        gl.glViewport(0, 0, w, h)

        progs = _load_programs(gl)
        colors = (label_colors(labels) if labels is not None
                  else np.zeros((len(points), 3), np.float32))
        scene = _upload_scene(gl, points, colors, boxes)
        proj = perspective(np.deg2rad(50.0), w / h, 0.5, 500.0)
        view = look_at(orbit_eye(center, camera_distance, azimuth,
                                 elevation), center, (0, 0, 1))
        mode = (1 if labels is not None else 0) if render_mode is None \
            else render_mode
        _draw(gl, progs, scene, proj, view, point_size=point_size,
              render_mode=mode)
        gl.glFinish()
        buf = gl.glReadPixels(0, 0, w, h, gl.GL_RGB, gl.GL_UNSIGNED_BYTE)
        img = np.frombuffer(buf, np.uint8).reshape(h, w, 3)
        return img[::-1]  # GL's origin is bottom-left
    finally:
        ctx.close()


def show_point_cloud(
    points: np.ndarray,
    labels: Optional[np.ndarray] = None,
    boxes: Optional[np.ndarray] = None,
    *,
    size: Tuple[int, int] = (1280, 960),
    point_size: float = 2.0,
) -> None:
    """Interactive viewer (reference ``show_point_cloud`` equivalent).

    Drag = orbit, scroll = zoom, ``c`` = toggle intensity/label colors,
    ESC = quit. Requires a display; for headless use
    :func:`render_point_cloud`.
    """
    import glfw
    from OpenGL import GL as gl

    if not glfw.init():
        raise RuntimeError(
            "glfw.init failed (no display?) — use render_point_cloud()")
    try:
        win = glfw.create_window(size[0], size[1], "mask_bev_tpu_torch", None,
                                  None)
        if not win:
            raise RuntimeError("glfw window creation failed")
        glfw.make_context_current(win)
        progs = _load_programs(gl)
        colors = (label_colors(labels) if labels is not None
                  else np.zeros((len(points), 3), np.float32))
        scene = _upload_scene(gl, points, colors, boxes)

        state = {"az": -np.pi / 2, "el": np.pi / 4, "dist": 60.0,
                 "mode": 1 if labels is not None else 0,
                 "drag": None}

        def on_scroll(_w, _dx, dy):
            state["dist"] = float(np.clip(state["dist"] * 0.9 ** dy, 2, 400))

        def on_key(w, key, _sc, action, _mods):
            if action != glfw.PRESS:
                return
            if key == glfw.KEY_ESCAPE:
                glfw.set_window_should_close(w, True)
            elif key == glfw.KEY_C:
                state["mode"] = 1 - state["mode"]

        def on_cursor(_w, x, y):
            if state["drag"] is not None:
                px, py = state["drag"]
                state["az"] -= (x - px) * 0.005
                state["el"] = float(np.clip(
                    state["el"] + (y - py) * 0.005,
                    -np.pi / 2 + 0.05, np.pi / 2 - 0.05))
                state["drag"] = (x, y)

        def on_button(w, button, action, _mods):
            if button == glfw.MOUSE_BUTTON_LEFT:
                state["drag"] = (glfw.get_cursor_pos(w)
                                 if action == glfw.PRESS else None)

        glfw.set_scroll_callback(win, on_scroll)
        glfw.set_key_callback(win, on_key)
        glfw.set_cursor_pos_callback(win, on_cursor)
        glfw.set_mouse_button_callback(win, on_button)

        while not glfw.window_should_close(win):
            fw, fh = glfw.get_framebuffer_size(win)
            gl.glViewport(0, 0, fw, fh)
            proj = perspective(np.deg2rad(50.0), fw / max(fh, 1), 0.5, 500.0)
            view = look_at(
                orbit_eye((0, 0, 0), state["dist"], state["az"],
                          state["el"]), (0, 0, 0), (0, 0, 1))
            _draw(gl, progs, scene, proj, view, point_size=point_size,
                  render_mode=state["mode"])
            glfw.swap_buffers(win)
            glfw.poll_events()
    finally:
        glfw.terminate()
