"""CKKS core of the port: RNS tables, NTT, polys, BConv, keys, HE ops."""
