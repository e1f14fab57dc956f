"""Client-side WebGL2 gaussian-splat viewer (PyTorch port of
``gsplat_tpu/viz/webgl_viewer.py``).

The server packs the model once (:func:`pack_splats`); the page
(``VIEWER_HTML``, served at ``/viewer`` by ``viz/render_app.py``) projects
each gaussian with the EWA math of ``ops/preprocess.py``, depth-sorts on
camera motion and composites in the browser, with no round trip a frame.
The page is the JAX module's, byte for byte: its bytes are the wire
contract of ``/viewer``.

Wire format (``/api/splats``, little-endian)::

    magic   u32   0x54505347 ("GSPT")
    version u32   1
    count   u32   N
    flags   u32   reserved (0)
    pos     f32[N,3]
    cov     f32[N,6]   upper triangle (c00 c01 c02 c11 c12 c22), world space
    rgba    u8[N,4]    DC-band color (deg-0 SH) + sigmoid opacity

``pack_splats`` gathers the alive rows of the model's activated fields on
the model's device and reads them back once; the covariance, colour and
rounding are the JAX module's numpy arithmetic on those rows, so the
layout and the rounding are the same.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

MAGIC = 0x54505347  # "GSPT"
SH_C0 = 0.28209479177387814


def _quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """[N,4] (w,x,y,z, already normalized) -> [N,3,3]."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(-1, 3, 3)


def pack_splats(gaussians) -> bytes:
    """Pack the alive gaussians into the /api/splats wire format.

    Covariances are composed world-side (Sigma = R S S^T R^T, the same
    composition ``ops/preprocess.py`` builds before the EWA projection)
    so the client shader only does the per-frame view-dependent half.
    """
    # the alive rows of the activated fields, read back in one copy
    sel = torch.nonzero(gaussians.aux.alive)[:, 0]
    fields = (gaussians.get_xyz, gaussians.get_scaling,
              gaussians.get_rotation, gaussians.get_opacity,
              gaussians.params.features_dc[:, 0])
    rows = torch.cat([f[sel] for f in fields], dim=1).cpu().numpy()
    pos, scale, rot, opa, dc = np.split(rows, [3, 6, 10, 11], axis=1)

    R = _quat_to_rotmat(rot)                        # [N,3,3]
    M = R * scale[:, None, :]                       # R @ diag(s)
    cov = np.einsum("nij,nkj->nik", M, M)           # [N,3,3] PSD
    cov6 = np.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
                     cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]],
                    axis=-1).astype(np.float32)     # [N,6]

    rgb = np.clip(SH_C0 * dc + 0.5, 0.0, 1.0)
    rgba = np.concatenate([rgb, np.clip(opa, 0.0, 1.0)], axis=-1)
    rgba_u8 = np.round(rgba * 255.0).astype(np.uint8)

    n = pos.shape[0]
    head = struct.pack("<IIII", MAGIC, 1, n, 0)
    return (head + np.ascontiguousarray(pos).tobytes() + cov6.tobytes()
            + rgba_u8.tobytes())


def unpack_splats(buf: bytes):
    """Inverse of :func:`pack_splats` (tests + python clients)."""
    magic, version, n, _flags = struct.unpack_from("<IIII", buf, 0)
    if magic != MAGIC or version != 1:
        raise ValueError("bad splat buffer header")
    o = 16
    pos = np.frombuffer(buf, np.float32, n * 3, o).reshape(n, 3)
    o += n * 12
    cov = np.frombuffer(buf, np.float32, n * 6, o).reshape(n, 6)
    o += n * 24
    rgba = np.frombuffer(buf, np.uint8, n * 4, o).reshape(n, 4)
    return pos, cov, rgba


def scene_info(gaussians, cam=None) -> dict:
    """JSON blob the client uses to frame the scene (/api/viewer-info)."""
    sel = torch.nonzero(gaussians.aux.alive)[:, 0]
    pos = gaussians.get_xyz[sel].cpu().numpy()
    if len(sel):
        center = pos.mean(axis=0)
        extent = float(np.percentile(
            np.linalg.norm(pos - center, axis=1), 95)) or 1.0
    else:
        center, extent = np.zeros(3), 1.0
    info = {"count": int(len(sel)),
            "center": [float(v) for v in center],
            "extent": extent}
    if cam is not None:
        info["fovy"] = float(cam.FoVy)
        info["fovx"] = float(cam.FoVx)
    return info


VIEWER_HTML = r"""<!doctype html><html><head><meta charset="utf-8">
<title>gsplat_tpu webgl viewer</title><style>
 html,body{margin:0;height:100%;overflow:hidden;background:#000;color:#ccd}
 #c{width:100%;height:100%;display:block}
 #hud{position:fixed;top:8px;left:8px;font:12px monospace;
      background:rgba(0,0,0,.55);padding:6px 8px;border-radius:4px}
 a{color:#8cf}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">loading…</div>
<script>
"use strict";
// ---------- tiny matrix helpers (column-major, GL convention) ----------
function persp(fovy, aspect, zn, zf) {
  const f = 1 / Math.tan(fovy / 2);
  return new Float32Array([
    f / aspect, 0, 0, 0,
    0, f, 0, 0,
    0, 0, (zf + zn) / (zn - zf), -1,
    0, 0, 2 * zf * zn / (zn - zf), 0]);
}
function lookAt(eye, tgt, up) {
  // world -> camera, camera looks down -z
  const zx = eye[0]-tgt[0], zy = eye[1]-tgt[1], zz = eye[2]-tgt[2];
  let zl = Math.hypot(zx, zy, zz); const z = [zx/zl, zy/zl, zz/zl];
  const x = [up[1]*z[2]-up[2]*z[1], up[2]*z[0]-up[0]*z[2],
             up[0]*z[1]-up[1]*z[0]];
  const xl = Math.hypot(...x); x[0]/=xl; x[1]/=xl; x[2]/=xl;
  const y = [z[1]*x[2]-z[2]*x[1], z[2]*x[0]-z[0]*x[2], z[0]*x[1]-z[1]*x[0]];
  const d = e => -(e[0]*eye[0] + e[1]*eye[1] + e[2]*eye[2]);
  return new Float32Array([
    x[0], y[0], z[0], 0,  x[1], y[1], z[1], 0,
    x[2], y[2], z[2], 0,  d(x), d(y), d(z), 1]);
}

// ---------- shaders: EWA projection, same math as ops/preprocess ----------
const VS = `#version 300 es
precision highp float; precision highp int; precision highp sampler2D;
uniform sampler2D uTex;      // 3 RGBA32F texels per splat
uniform mat4 uView, uProj;
uniform vec2 uFocal, uViewport;
in uint aIndex;              // sorted splat id, one per instance
out vec4 vColor;
out vec2 vPos;               // quad coords in sigma units
void main(){
  int base = int(aIndex) * 3;
  int tw = textureSize(uTex, 0).x;
  vec4 t0 = texelFetch(uTex, ivec2(base % tw, base / tw), 0);
  vec4 t1 = texelFetch(uTex, ivec2((base+1) % tw, (base+1) / tw), 0);
  vec4 t2 = texelFetch(uTex, ivec2((base+2) % tw, (base+2) / tw), 0);
  vec3 p = t0.xyz;
  uint c = floatBitsToUint(t0.w);
  vColor = vec4(float(c & 255u), float((c>>8) & 255u),
                float((c>>16) & 255u), float((c>>24) & 255u)) / 255.0;
  vec4 tc = uView * vec4(p, 1.0);
  if (tc.z > -0.05) { gl_Position = vec4(0,0,2,1); return; }  // behind cam
  // world cov from upper triangle
  mat3 S = mat3(t1.x, t1.y, t1.z,  t1.y, t1.w, t2.x,  t1.z, t2.x, t2.y);
  mat3 W = mat3(uView);             // world->cam rotation
  // EWA Jacobian at tc (preprocess.py: J W Sigma W^T J^T + 0.3 I)
  float tz = tc.z, tz2 = tz * tz;
  mat3x2 J = mat3x2(uFocal.x / tz, 0.0,
                    0.0, uFocal.y / tz,
                    -uFocal.x * tc.x / tz2, -uFocal.y * tc.y / tz2);
  mat3x2 JW = J * W;
  // cov2d = JW * S * JW^T  (2x2, symmetric)
  vec3 r0 = vec3(JW[0][0], JW[1][0], JW[2][0]);
  vec3 r1 = vec3(JW[0][1], JW[1][1], JW[2][1]);
  float a = dot(r0, S * r0) + 0.3;
  float b = dot(r0, S * r1);
  float cc = dot(r1, S * r1) + 0.3;
  // principal axes of the 2x2
  float mid = 0.5 * (a + cc);
  float disc = sqrt(max(0.0001, 0.25 * (a - cc) * (a - cc) + b * b));
  float l1 = mid + disc, l2 = max(mid - disc, 0.0001);
  vec2 e1 = (abs(b) > 1e-6) ? normalize(vec2(b, l1 - a))
          : ((a >= cc) ? vec2(1, 0) : vec2(0, 1));
  vec2 e2 = vec2(-e1.y, e1.x);
  vec2 v1 = e1 * sqrt(l1), v2 = e2 * sqrt(l2);   // pixels per sigma
  vec2 corner = vec2(float(gl_VertexID & 1) * 2.0 - 1.0,
                     float((gl_VertexID >> 1) & 1) * 2.0 - 1.0) * 3.0;
  vPos = corner;
  vec4 pc = uProj * tc;
  vec2 ndc = pc.xy / pc.w;
  // J-space pixel axes are (fx*tx/tz, fy*ty/tz) with tz<0 — both are
  // negated w.r.t. NDC for a -z-looking camera, so the J->NDC map is
  // diag(-2/W, -2/H); getting one sign wrong mirrors anisotropic splats.
  vec2 dpix = corner.x * v1 + corner.y * v2;     // J-space pixel offset
  ndc -= dpix * 2.0 / uViewport;
  gl_Position = vec4(ndc, pc.z / pc.w, 1.0);
}`;
const FS = `#version 300 es
precision highp float;
in vec4 vColor; in vec2 vPos;
out vec4 o;
void main(){
  float g = exp(-0.5 * dot(vPos, vPos));
  float a = vColor.a * g;
  if (a < 0.0039) discard;
  o = vec4(vColor.rgb * a, a);          // premultiplied
}`;

// ---------- boot ----------
const canvas = document.getElementById('c');
const hud = document.getElementById('hud');
const gl = canvas.getContext('webgl2', {antialias: false});
if (!gl) { hud.textContent = 'WebGL2 unavailable'; throw 'no webgl2'; }

function mkShader(type, src) {
  const s = gl.createShader(type); gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(s);
  return s;
}
const prog = gl.createProgram();
gl.attachShader(prog, mkShader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, mkShader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog);
if (!gl.getProgramParameter(prog, gl.LINK_STATUS))
  throw gl.getProgramInfoLog(prog);
gl.useProgram(prog);
const U = n => gl.getUniformLocation(prog, n);

let N = 0, pos, cov, depth, order, idxBuf, info = {};
let cam = {theta: 0.6, phi: 0.45, radius: 3, target: [0,0,0], fovy: 0.8};

async function load() {
  info = await (await fetch('/api/viewer-info')).json();
  const buf = await (await fetch('/api/splats')).arrayBuffer();
  const dv = new DataView(buf);
  if (dv.getUint32(0, true) !== 0x54505347) throw 'bad magic';
  N = dv.getUint32(8, true);
  let o = 16;
  pos = new Float32Array(buf, o, N * 3); o += N * 12;
  cov = new Float32Array(buf, o, N * 6); o += N * 24;
  const rgba = new Uint32Array(buf.slice(o, o + N * 4));
  // pack into RGBA32F texture: [x y z rgba][c00 c01 c02 c11][c12 c22 0 0]
  const TW = 3 * 512;                       // texel width, multiple of 3
  const TH = Math.ceil(N * 3 / TW);
  const tex = new Float32Array(TW * TH * 4);
  const texU32 = new Uint32Array(tex.buffer);
  for (let i = 0; i < N; i++) {
    const t = i * 12;
    tex[t] = pos[i*3]; tex[t+1] = pos[i*3+1]; tex[t+2] = pos[i*3+2];
    texU32[t+3] = rgba[i];
    tex[t+4] = cov[i*6]; tex[t+5] = cov[i*6+1];
    tex[t+6] = cov[i*6+2]; tex[t+7] = cov[i*6+3];
    tex[t+8] = cov[i*6+4]; tex[t+9] = cov[i*6+5];
  }
  const t = gl.createTexture();
  gl.bindTexture(gl.TEXTURE_2D, t);
  gl.texImage2D(gl.TEXTURE_2D, 0, gl.RGBA32F, TW, TH, 0, gl.RGBA,
                gl.FLOAT, tex);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MIN_FILTER, gl.NEAREST);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MAG_FILTER, gl.NEAREST);

  depth = new Float32Array(N);
  order = new Uint32Array(N);
  idxBuf = gl.createBuffer();
  const loc = gl.getAttribLocation(prog, 'aIndex');
  gl.bindBuffer(gl.ARRAY_BUFFER, idxBuf);
  gl.enableVertexAttribArray(loc);
  gl.vertexAttribIPointer(loc, 1, gl.UNSIGNED_INT, 0, 0);
  gl.vertexAttribDivisor(loc, 1);

  cam.target = info.center.slice();
  cam.radius = info.extent * 2.2;
  cam.fovy = info.fovy || 0.8;
  sortSplats(viewMatrix());
  hud.innerHTML = `${N.toLocaleString()} splats (DC band, client WebGL2) ` +
    `&middot; drag orbit / wheel zoom / shift-drag pan<br>` +
    `server-side TPU renderer (full SH): <a href="/">/</a>`;
  requestAnimationFrame(draw);
}

function viewMatrix() {
  const ct = Math.cos(cam.theta), st = Math.sin(cam.theta);
  const cp = Math.cos(cam.phi), sp = Math.sin(cam.phi);
  const eye = [cam.target[0] + cam.radius * cp * st,
               cam.target[1] + cam.radius * sp,
               cam.target[2] + cam.radius * cp * ct];
  return lookAt(eye, cam.target, [0, 1, 0]);
}

// counting sort over quantized view depth, back-to-front
function sortSplats(V) {
  const r2 = [V[2], V[6], V[10], V[14]];   // camera-z row (column-major)
  let mn = 1e30, mx = -1e30;
  for (let i = 0; i < N; i++) {
    const d = -(r2[0]*pos[i*3] + r2[1]*pos[i*3+1] + r2[2]*pos[i*3+2] + r2[3]);
    depth[i] = d;
    if (d < mn) mn = d; if (d > mx) mx = d;
  }
  const B = 65536, hist = new Uint32Array(B + 1);
  const s = (B - 1) / Math.max(1e-9, mx - mn);
  const bin = new Uint32Array(N);
  for (let i = 0; i < N; i++) {
    const b = (B - 1 - ((depth[i] - mn) * s)) | 0;  // far first
    bin[i] = b; hist[b + 1]++;
  }
  for (let b = 0; b < B; b++) hist[b + 1] += hist[b];
  for (let i = 0; i < N; i++) order[hist[bin[i]]++] = i;
  gl.bindBuffer(gl.ARRAY_BUFFER, idxBuf);
  gl.bufferData(gl.ARRAY_BUFFER, order, gl.DYNAMIC_DRAW);
}

let needSort = false;
function draw() {
  const w = canvas.clientWidth, h = canvas.clientHeight;
  if (canvas.width !== w || canvas.height !== h) {
    canvas.width = w; canvas.height = h;
  }
  gl.viewport(0, 0, w, h);
  gl.disable(gl.DEPTH_TEST);
  gl.enable(gl.BLEND);
  gl.blendFunc(gl.ONE, gl.ONE_MINUS_SRC_ALPHA);
  gl.clearColor(0, 0, 0, 1);
  gl.clear(gl.COLOR_BUFFER_BIT);

  const V = viewMatrix();
  if (needSort) { sortSplats(V); needSort = false; }
  const fy = h / (2 * Math.tan(cam.fovy / 2));
  gl.uniformMatrix4fv(U('uView'), false, V);
  gl.uniformMatrix4fv(U('uProj'), false,
                      persp(cam.fovy, w / h, 0.02, 1000));
  gl.uniform2f(U('uFocal'), fy, fy);
  gl.uniform2f(U('uViewport'), w, h);
  gl.drawArraysInstanced(gl.TRIANGLE_STRIP, 0, 4, N);
  requestAnimationFrame(draw);
}

// ---------- input ----------
let drag = null;
canvas.addEventListener('mousedown', e => {
  drag = {x: e.clientX, y: e.clientY, pan: e.shiftKey || e.button === 2};
});
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.pan) {
    const V = viewMatrix(), s = cam.radius * 0.0015;
    cam.target[0] -= s * (V[0]*dx - V[1]*dy);
    cam.target[1] -= s * (V[4]*dx - V[5]*dy);
    cam.target[2] -= s * (V[8]*dx - V[9]*dy);
  } else {
    cam.theta -= dx * 0.005;
    cam.phi = Math.min(1.5, Math.max(-1.5, cam.phi + dy * 0.005));
  }
  needSort = true;
});
canvas.addEventListener('wheel', e => {
  e.preventDefault();
  cam.radius *= Math.exp(e.deltaY * 0.001);
  needSort = true;
}, {passive: false});
canvas.addEventListener('contextmenu', e => e.preventDefault());

load().catch(e => hud.textContent = 'load failed: ' + e);
</script></body></html>
"""
