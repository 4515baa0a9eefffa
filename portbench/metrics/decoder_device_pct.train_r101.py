"""The PPM-DeepSup decoder's share of the forward's device time: the device
time of the kernels launched inside the program's ``fcn.decoder`` span
over that of ``fcn.encoder`` and ``fcn.decoder`` together, each the median
over the traced window's steps (drivers/train_zoo.py credits them with
lib/program_trace.RuntimeTrace). None where the program records neither
span."""


def read(data: dict):
    enc, dec = data.get("encoder_device_s", 0.0), data.get("decoder_device_s", 0.0)
    if enc <= 0 or dec <= 0:
        return None
    return 100.0 * dec / (enc + dec)
