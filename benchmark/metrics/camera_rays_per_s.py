"""camera_rays_per_s: camera rays (width x height x spp) of the frames the
window completed, over the window's seconds; a frame is complete when its
linear framebuffer is on the host. Host clock."""


def read(rec):
    rays = rec.work.get("camera_rays")
    if not rays or not rec.window_s > 0:
        return None
    return rays / rec.window_s
