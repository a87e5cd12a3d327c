"""Entry (`slam.SLAM.run`): synchronising CUDA calls per frame over the
window, counted by `syncs.SyncCounter` in the traced run."""


def read(rec):
    if rec.syncs is None or not rec.frames_in_close:
        return None
    return rec.syncs / rec.frames_in_close
