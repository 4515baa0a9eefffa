"""Dataset readers, the PNG and PFM codecs, stereo rectification, the
decode-ahead loader, trajectory output and error metrics."""
