from .cameras import (  # noqa: F401
    PerspectiveCamera, OrthographicCamera, EnvironmentCamera,
    make_perspective, make_orthographic, make_environment, cone_start,
    generate_rays, generate_rays_weighted, camera_we, camera_pdf_we, camera_sample_wi,
)
from .realistic import RealisticCamera, make_realistic, DEMO_LENS  # noqa: F401
