"""Frozen copies of the plain (eager PyTorch and numpy) modules of
`uhc_tpu_torch`, taken at commit 6fd2048, for the benchmark's reference.

Every import of the package is rewritten to this one, so nothing here
loads the program. Left out of the copies: the kernel routing of
`envs/humanoid_im.py` (`make_env_step_batched`) and the native mesh
toolkit (`smpl/mesh.py` runs its numpy path only). The benchmark's
yardstick must not move with the program, so these files are never
edited to follow it: a later change to the port's plain chain is checked
against this copy.
"""
