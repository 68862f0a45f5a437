"""The benchmark's yardstick: operations, bytes and peaks that later
changes to the program cannot move.

``cost`` holds frozen copies of the per-call cost functions of the
port's flash and decode kernels, ``flops`` the model-operation count of
a configuration, ``peaks`` the published peaks of one NVIDIA H100.
"""
