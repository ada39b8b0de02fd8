#!/bin/sh
# Build the native host-side builder library.
set -e
cd "$(dirname "$0")"
CXX=${CXX:-c++}
# build under a private name, then rename: concurrent first uses (test
# workers) never load a half-written library
$CXX -O3 -shared -fPIC -o libedcore.so.tmp$$ edcore.cpp
mv -f libedcore.so.tmp$$ libedcore.so
echo "built $(pwd)/libedcore.so"
