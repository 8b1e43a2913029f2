"""rgbd.K1.roofline_pct: the least time of K1's work over the device time
of everything launched inside rgbd.K1 (K1, its checks and its launch
operands), in %.  K1's work is work.rgbd_integrate's without the hash
slots' scan and the window's write, which are the compaction's: the
frame read once (depth f32 + colour 3 x u8 a pixel), each window voxel's
state read once and each entry's flags written, and work.PROJECT_FLOPS
operations a voxel."""
import work


def k1(stats, sensor):
    n, vox = stats["occupied_blocks"], work.window_voxels(stats)
    nbytes = (sensor["rows"] * sensor["cols"] * 7 + vox * work.VOXEL_STATE
              + n * work.FLAGS)
    return nbytes, vox * work.PROJECT_FLOPS


def read(trace):
    return work.roofline_pct(trace, "rgbd.K1",
                             lambda s: k1(s, trace.sensor))
