"""Host data: HDR IO, the HDR-Synth dataset, the sample loader and the JPEG
round trip (the port's copies of numpy-only modules of ``singlehdr_tpu.data``)."""
