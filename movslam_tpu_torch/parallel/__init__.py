"""Scale-out over a torch.distributed process group: several streams per
call (multistream), point-sharded bundle adjustment (sharded_ba) and global
BA over a group (gba). Port of movslam_tpu/parallel/."""
