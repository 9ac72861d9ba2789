"""Host-side data of the port: the dataset and feature stores, the loader
with its pinned staging, the synthetic fixture, vocab decoding and n-gram
document frequencies."""
