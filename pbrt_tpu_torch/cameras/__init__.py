from .cameras import (PerspectiveCamera, make_perspective, cone_start,  # noqa: F401
                      generate_rays_weighted, camera_we, camera_pdf_we, camera_sample_wi)
