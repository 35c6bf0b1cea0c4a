"""Event bus (C4) + interactive viewer server (C5/C26 analog)."""
from __future__ import annotations

import json
import urllib.request

import numpy as np
import pytest

from rtm_tpu import Camera, RenderConfig, build_tracer_scene, load_scene
from rtm_tpu.runtime.events import (AppClose, EventBus, KeyPressed,
                                    MouseMove, ScrollMoved)
from rtm_tpu.runtime.renderer import ProgressiveRenderer
from rtm_tpu.viewer import CameraController, ViewerServer

CFG = RenderConfig(width=16, height=16, max_bounces=2, max_frames=1,
                   draw_environment=True, accumulate=True)


def test_event_bus_order_and_types():
    bus = EventBus()
    seen = []
    bus.register(KeyPressed, lambda e: seen.append(("k", e.key)))
    bus.register(MouseMove, lambda e: seen.append(("m", e.dx)))
    bus.emit(KeyPressed(key="w"))
    bus.emit(MouseMove(x=0, y=0, dx=3.0))
    bus.emit(KeyPressed(key="a"))
    assert bus.process() == 3
    assert seen == [("k", "w"), ("m", 3.0), ("k", "a")]
    assert bus.process() == 0


def test_camera_controller_semantics():
    cam = Camera()
    resets = []
    ctl = CameraController(cam, lambda: resets.append(1))
    p0 = np.array(cam.position, float)
    ctl.key(KeyPressed(key="w"))                 # forward = -z
    assert cam.position[2] < p0[2] and len(resets) == 1
    d0 = np.array(cam.direction, float)
    ctl.look(MouseMove(x=0, y=0, dx=50.0, dy=0.0))
    assert not np.allclose(cam.direction, d0) and len(resets) == 2
    np.testing.assert_allclose(np.linalg.norm(cam.direction), 1.0, atol=1e-6)
    ctl.scroll(ScrollMoved(offset=5.0))
    assert cam.fov == 40.0 and len(resets) == 3


@pytest.fixture
def server():
    scene = build_tracer_scene(load_scene(1))
    r = ProgressiveRenderer(scene, Camera(), CFG)
    s = ViewerServer(r, port=0)
    import threading
    threading.Thread(target=s._httpd.serve_forever, daemon=True).start()
    yield s
    s._httpd.shutdown()


def _get(s, path):
    return urllib.request.urlopen(
        f"http://127.0.0.1:{s.port}{path}", timeout=10)


def test_viewer_endpoints(server):
    s = server
    s.step()   # one manual frame (no render thread in tests)
    page = _get(s, "/").read()
    assert b"rtm_tpu" in page
    png = _get(s, "/frame.png").read()
    assert png.startswith(b"\x89PNG")
    state = json.loads(_get(s, "/state").read())
    assert state["frame_index"] == 1
    assert state["width"] == CFG.width

    # progressive accumulation advances
    s.step()
    assert json.loads(_get(s, "/state").read())["frame_index"] == 2

    # movement input resets accumulation (reference RayTracing.cpp:625)
    req = urllib.request.Request(
        f"http://127.0.0.1:{s.port}/input",
        data=json.dumps({"keys": ["w"]}).encode(), method="POST")
    urllib.request.urlopen(req, timeout=10).read()
    s.step()   # drains the event, then renders frame 1 of the new view
    assert json.loads(_get(s, "/state").read())["frame_index"] == 1


def test_app_close_event():
    bus = EventBus()
    closed = []
    bus.register(AppClose, lambda e: closed.append(1))
    bus.emit(AppClose())
    bus.process()
    assert closed == [1]


def test_viewer_settings_parity(server):
    """Settings-panel round trip (ref RayTracing.cpp:73-150): slider edits
    apply without resetting accumulation; Reset and camera edits reset."""
    s = server
    s.step()
    s.step()
    assert json.loads(_get(s, "/state").read())["frame_index"] == 2

    def post(payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{s.port}/settings",
            data=json.dumps(payload).encode(), method="POST")
        return json.loads(urllib.request.urlopen(req, timeout=10).read())

    # bounces slider: config applies, accumulation keeps blending
    assert post({"max_bounces": 3})["ok"]
    assert s.renderer.cfg.max_bounces == 3
    s.step()
    st = json.loads(_get(s, "/state").read())
    assert st["frame_index"] == 3 and st["max_bounces"] == 3

    # accumulate checkbox off -> frame_index pins to 1 (shader:81 analog)
    assert post({"accumulate": False})["ok"]
    s.step()
    assert json.loads(_get(s, "/state").read())["frame_index"] == 1
    assert post({"accumulate": True})["ok"]

    # Reset button
    s.step(); s.step()
    assert post({"reset": True})["ok"]
    s.step()
    assert json.loads(_get(s, "/state").read())["frame_index"] == 1

    # camera edit resets + round-trips
    assert post({"fov": 60.0})["ok"]
    s.step()
    st = json.loads(_get(s, "/state").read())
    assert st["fov"] == 60.0 and st["frame_index"] == 1
