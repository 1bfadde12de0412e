from .style import (
    COLOR_AGENT,
    COLOR_BAD,
    COLOR_GOOD,
    COLOR_OBS_PRIMARY,
    COLOR_OBS_SECONDARY,
    COLOR_PRED,
    quality_color,
)
from .render import (
    RenderTracker,
    render_env,
    render_image_perception,
    render_lidar,
    render_light_dark,
)
