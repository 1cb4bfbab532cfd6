"""Data loading of the port: the datasets (`ade20k`, `cityscapes`, `voc`,
`coco`, `synthetic`), their transforms and the packaged label lists
(`labels`) are framework-free copies of the reference's modules; the
batch loader is `loader`."""
