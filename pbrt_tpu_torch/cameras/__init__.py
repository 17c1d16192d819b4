from .cameras import (PerspectiveCamera, make_perspective, cone_start,  # noqa: F401
                      generate_rays_weighted)
