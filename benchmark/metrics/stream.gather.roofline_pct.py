"""stream.gather.roofline_pct: the least time of the stream-outs' gather
and clear over the device time of everything launched inside
stream.gather, in %.  The work is counted from last_stats'
streamed_out_voxels (512 a res-0 block, 64 a res-1 block): each evicted
voxel's state (sdf, sumsq, weight, colour: 16 B) read once, written once
to the staging buffers and cleared once, at the H100's published HBM
rate.  The gather writes a res-1 block's staging row whole (512 lanes),
which the count leaves out, so the share can only read low.  None where
the range never opened or the program does not count the voxels."""
import work

VOXEL_BYTES = 16
PASSES = 3            # read, written to staging, cleared


def read(trace):
    if any("streamed_out_voxels" not in s for s in trace.stats):
        return None
    return work.roofline_pct(
        trace, "stream.gather",
        lambda s: (PASSES * VOXEL_BYTES * s["streamed_out_voxels"], 0))
