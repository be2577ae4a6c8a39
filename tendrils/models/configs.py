"""Named sim configurations (the framework's "model zoo").

Mirrors BASELINE.md's five benchmark configs and the reference's quality
tiers. `build(name)` returns a spawned, ready-to-step engine.
"""

from ..engine import EngineConfig, Tendrils
from ..spawners import spawn_ball

# Splat sampling of the published configs: two points along each segment
# and one row across it, for both passes.
SAMPLING = {"flow_samples": 2, "flow_rows": 1, "view_samples": 2}


# Published sizes: (rootNum, view resolution (H, W)) of each named config.
PUBLISHED = {
    "default-preview": (256, (360, 640)),
    "1m-flow": (1024, (1080, 1920)),
    "4m-respawn-stress": (2048, (1080, 1920)),
    "optical-flow-driven": (512, (720, 1280)),
    "16m-live-show": (4096, (2160, 3840)),
}


def _spawned(cfg, radius=0.6, speed=0.01):
    eng = Tendrils(cfg)
    eng.setup()
    spawn_ball(radius=radius, speed=speed).spawn(eng)
    return eng


def _published(name, view_res=None):
    root, view = PUBLISHED[name]
    return _spawned(EngineConfig(root_num=root, view_res=view_res or view,
                                 **SAMPLING))


def default_preview(view_res=None):
    """BASELINE config 1 family: 256² particles, light preview."""
    return _published("default-preview", view_res)


def one_m_flow(view_res=None):
    """BASELINE config 2: 1M particles, flow feedback + 1080p trail."""
    return _published("1m-flow", view_res)


def respawn_stress_4m(view_res=None):
    """BASELINE config 3: 4M particles (respawn stress driven by caller)."""
    return _published("4m-respawn-stress", view_res)


def optical_flow_driven(view_res=None):
    """BASELINE config 4: camera-flow-driven 512² sim (feed frames via
    `media.OpticalFlow` + `engine.composite_flow`)."""
    return _published("optical-flow-driven", view_res)


def live_show_16m(view_res=None):
    """BASELINE config 5 / north star: 16.7M particles, 4K trail buffer."""
    return _published("16m-live-show", view_res)


def quality_tier(level, view_res=(1080, 1920)):
    """The reference's quality tiers — ref `demo.main.js:978-1009`:
    rootNum × {1, 2, 4} with damping nudged down per tier."""
    from ..state import default_state
    d = default_state()
    root = d["rootNum"] * (2 ** level)
    eng = _spawned(EngineConfig(root_num=root, view_res=view_res,
                                **SAMPLING))
    eng.state["damping"] = d["damping"] - 1e-3 * level
    return eng


MODELS = {
    "default-preview": default_preview,
    "1m-flow": one_m_flow,
    "4m-respawn-stress": respawn_stress_4m,
    "optical-flow-driven": optical_flow_driven,
    "16m-live-show": live_show_16m,
}


def build(name, **kw):
    """Build a named model configuration."""
    return MODELS[name](**kw)
