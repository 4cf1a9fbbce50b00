"""Swin-T: matmul launches a traced batch whose operand TMA cannot take,
loaded by masked copies (the port's ``launch.masked_operand``)."""
from perfbench import program


def read(ctx):
    return program.launches(ctx, "vision.swin_forward",
                            "launch.masked_operand")
