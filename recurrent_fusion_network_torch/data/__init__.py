"""Host-side data of the port: the dataset and feature stores (packed and
sharded, with the native row gather), the loader with its pinned staging,
the synthetic fixture, vocabularies, and the prepro CLIs (labels, n-gram
document frequencies)."""
