"""Blender -> akari scene exporter. Runs INSIDE Blender 4.x:

    blender -b scene.blend -P tools/blender_exporter.py -- -o out_dir

Reference: crates/akari_scenegraph/python/exporter.py (749 lines driving the
`py_akari_import` C ABI). This adaptation keeps the same Cycles-subset node
mapping and scene schema but exchanges data through the in-process Python
import API (akari_render/api.py) with numpy `foreach_get` extraction —
no FFI, no raw DNA pointers (SURVEY.md §7.1 "exchange data via files/numpy").

Only numpy + bpy are required inside Blender (no jax import).
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

# make the repo importable inside Blender's python
_ROOT = os.environ.get("AKARI_RENDER_ROOT") or str(Path(__file__).resolve().parent.parent)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import bpy  # noqa: E402
import bpy.types as T  # noqa: E402

from akari_render.api import SceneImportApi  # noqa: E402


def _toposort(node_tree):
    out = []
    seen = set()

    def dfs(node):
        if node in seen:
            return
        seen.add(node)
        for inp in node.inputs:
            for link in inp.links:
                dfs(link.from_node)
        out.append(node)

    for n in node_tree.nodes:
        dfs(n)
    return out


class MaterialExporter:
    """Cycles node tree -> ShaderGraph JSON (ref exporter.py:191-488)."""

    def __init__(self, scene_exporter):
        self.scene = scene_exporter
        self.graph = {}
        self.tmp = 0
        self.node_names = {}
        self.output = None

    def _fresh(self, prefix="$tmp"):
        self.tmp += 1
        return f"{prefix}_{self.tmp}"

    def _const(self, node_dict) -> dict:
        name = self._fresh()
        self.graph[name] = node_dict
        return {"id": name}

    def _uplift(self, rgb_ref) -> dict:
        return self._const({"type": "spectral_uplift", "rgb": rgb_ref})

    def _input(self, node, key, kind, use_default=True):
        """Resolve one input socket to a node ref (ref get_node_input)."""
        sock = node.inputs[key]
        if sock.links:
            src = sock.links[0].from_node
            ref = {"id": self.node_names[src]}
            out_name = sock.links[0].from_socket.name
            if isinstance(src, (T.ShaderNodeTexCoord, T.ShaderNodeSeparateColor)):
                field = {"UV": "uv", "Red": "Red", "Green": "Green", "Blue": "Blue"}[out_name]
                ref = self._const({"type": "extract", "node": ref, "field": field})
            if kind == "spectrum":
                ref = self._uplift(ref)
            return ref
        if not use_default:
            return None
        v = sock.default_value
        if kind == "float":
            return self._const({"type": "float", "value": float(v)})
        if kind == "float3":
            return self._const({"type": "float3", "value": [float(v[i]) for i in range(3)]})
        if kind == "spectrum":
            rgb = self._const(
                {"type": "rgb", "value": [float(v[i]) for i in range(3)], "colorspace": "srgb"}
            )
            return self._uplift(rgb)
        raise ValueError(kind)

    def export_node(self, node, name):
        d = {}

        def inp(bkey, akey, kind, use_default=True):
            r = self._input(node, bkey, kind, use_default)
            if r is not None:
                d[akey] = r

        if isinstance(node, T.ShaderNodeBsdfPrincipled):
            d["type"] = "principled"
            d["preference"] = "mix"
            inp("Base Color", "base_color", "spectrum")
            inp("Roughness", "roughness", "float")
            inp("Metallic", "metallic", "float")
            inp("Specular IOR Level", "specular_ior_level", "float")
            inp("Specular Tint", "specular_tint", "spectrum")
            inp("Emission Color", "emission_color", "spectrum")
            inp("Emission Strength", "emission_strength", "float")
            inp("Coat Weight", "coat_weight", "float")
            inp("Coat Roughness", "coat_roughness", "float")
            inp("Coat Normal", "coat_normal", "float3")
            inp("Coat IOR", "coat_ior", "float")
            inp("Coat Tint", "coat_tint", "spectrum")
            inp("Transmission Weight", "transmission_weight", "float")
            inp("IOR", "ior", "float")
            inp("Sheen Weight", "sheen_weight", "float")
            inp("Sheen Tint", "sheen_tint", "spectrum")
            inp("Subsurface Weight", "subsurface_weight", "float")
            inp("Subsurface Radius", "subsurface_radius", "float3")
            inp("Subsurface Scale", "subsurface_scale", "float")
            inp("Subsurface Anisotropy", "subsurface_anisotropy", "float")
            inp("Anisotropic Rotation", "anisotropic_rotation", "float")
            inp("Anisotropic", "anisotropic", "float")
            inp("Alpha", "alpha", "float")
            inp("Normal", "normal", "float3")
            inp("Tangent", "tangent", "float3")
        elif isinstance(node, T.ShaderNodeBsdfGlass):
            d["type"] = "glass"
            inp("Color", "color", "spectrum")
            inp("Roughness", "roughness", "float")
            inp("IOR", "ior", "float")
        elif isinstance(node, T.ShaderNodeBsdfDiffuse):
            d["type"] = "diffuse"
            inp("Color", "color", "spectrum")
        elif isinstance(node, T.ShaderNodeEmission):
            d["type"] = "emission"
            inp("Color", "color", "spectrum")
            inp("Strength", "strength", "float")
        elif isinstance(node, T.ShaderNodeMixShader):
            d["type"] = "mix"
            inp("Fac", "factor", "float")
            d["first"] = self._input(node, 1, "bsdf")
            d["second"] = self._input(node, 2, "bsdf")
        elif isinstance(node, T.ShaderNodeOutputMaterial):
            d["type"] = "output"
            d["node"] = {"id": self.node_names[node.inputs["Surface"].links[0].from_node]}
            self.output = name
        elif isinstance(node, T.ShaderNodeTexCoord):
            d["type"] = "texcoords"
        elif isinstance(node, T.ShaderNodeSeparateColor):
            d["type"] = "separate_color"
            d["mode"] = {"RGB": "rgb"}[node.mode]
            inp("Color", "color", "float3")
        elif isinstance(node, T.ShaderNodeNormalMap):
            d["type"] = "normal_map"
            d["space"] = {"TANGENT": "tangent"}[node.space]
            inp("Color", "normal", "float3")
            inp("Strength", "strength", "float")
        elif isinstance(node, T.ShaderNodeMapping):
            d["type"] = "mapping"
            d["mapping"] = {"POINT": "point", "TEXTURE": "texture"}[node.vector_type]
            inp("Vector", "vector", "float3")
            inp("Location", "location", "float3")
            inp("Rotation", "rotation", "float3")
            inp("Scale", "scale", "float3")
        elif isinstance(node, T.ShaderNodeTexChecker):
            d["type"] = "checkerboard"
            inp("Color1", "color1", "spectrum")
            inp("Color2", "color2", "spectrum")
            inp("Scale", "scale", "float")
            inp("Vector", "vector", "float3", use_default=False)
        elif isinstance(node, T.ShaderNodeTexImage):
            img = node.image
            data = self.scene.export_image(img)
            d = {
                "type": "image",
                "image": {
                    "data": data,
                    "extension": {"REPEAT": "repeat", "EXTEND": "extend",
                                  "CLIP": "clip", "MIRROR": "mirror"}[node.extension],
                    "interpolation": {"Closest": "nearest"}.get(node.interpolation, "linear"),
                    "colorspace": {"sRGB": "srgb", "Non-Color": "none"}[
                        img.colorspace_settings.name
                    ],
                    "format": {"JPEG": "jpeg", "PNG": "png", "OPEN_EXR": "exr"}.get(
                        img.file_format, "png"
                    ),
                    "width": img.size[0],
                    "height": img.size[1],
                    "channels": img.channels,
                },
            }
            uv = self._input(node, "Vector", "float3", use_default=False)
            if uv is not None:
                d["uv"] = uv
        else:
            raise RuntimeError(f"Unsupported node type `{node.type}`")
        self.graph[name] = d

    def export(self, mat) -> dict:
        tree = mat.node_tree
        for i, node in enumerate(_toposort(tree)):
            self.node_names[node] = f"{node.name}"
        for node in _toposort(tree):
            self.export_node(node, self.node_names[node])
        assert self.output is not None, f"material {mat.name} has no output node"
        return {"nodes": self.graph, "output": {"id": self.output}, "kind": "surface"}


class SceneExporter:
    def __init__(self, out_dir):
        self.api = SceneImportApi()
        self.out_dir = out_dir
        self.exported_materials = {}
        self.exported_meshes = {}
        self.image_views = {}

    def export_image(self, img) -> dict:
        key = img.name
        if key not in self.image_views:
            # pack pixels as png bytes through blender's save
            import tempfile

            tmp = Path(tempfile.mkdtemp()) / f"{img.name}.png"
            img.save_render(str(tmp)) if img.packed_file is None else img.save(filepath=str(tmp))
            data = np.frombuffer(tmp.read_bytes(), np.uint8)
            self.image_views[key] = self.api.builder.add_array(f"img.{key}", data)
        return self.image_views[key]

    def export_material(self, mat) -> str:
        if mat.name not in self.exported_materials:
            graph = MaterialExporter(self).export(mat)
            self.exported_materials[mat.name] = self.api.import_material(mat.name, graph)
        return self.exported_materials[mat.name]

    def export_mesh(self, obj, depsgraph) -> str:
        mesh_name = obj.data.name + "_mesh"
        if mesh_name in self.exported_meshes:
            return mesh_name
        ev = obj.evaluated_get(depsgraph)
        me = ev.to_mesh()
        me.calc_loop_triangles()
        try:
            me.calc_tangents()
            has_tangents = True
        except RuntimeError:
            has_tangents = False
        nv = len(me.vertices)
        nt = len(me.loop_triangles)
        verts = np.empty(nv * 3, np.float32)
        me.vertices.foreach_get("co", verts)
        tris = np.empty(nt * 3, np.int32)
        me.loop_triangles.foreach_get("vertices", tris)
        loops_of_tri = np.empty(nt * 3, np.int32)
        me.loop_triangles.foreach_get("loops", loops_of_tri)
        # split normals per loop
        loop_normals = np.empty(len(me.loops) * 3, np.float32)
        me.loops.foreach_get("normal", loop_normals)
        corner_normals = loop_normals.reshape(-1, 3)[loops_of_tri]
        corner_tangents = None
        if has_tangents:
            lt = np.empty(len(me.loops) * 3, np.float32)
            me.loops.foreach_get("tangent", lt)
            corner_tangents = lt.reshape(-1, 3)[loops_of_tri]
        uvs = None
        if me.uv_layers.active is not None:
            luv = np.empty(len(me.loops) * 2, np.float32)
            me.uv_layers.active.data.foreach_get("uv", luv)
            uvs = luv.reshape(-1, 2)[loops_of_tri]
        mat_idx = np.empty(nt, np.int32)
        me.loop_triangles.foreach_get("material_index", mat_idx)
        if not (mat_idx != 0).any():
            mat_idx = np.zeros(1, np.int32)
        # Blender Z-up -> Akari Y-up: (x, y, z) -> (x, z, -y)
        def to_akari(a3):
            a3 = a3.reshape(-1, 3).copy()
            y = a3[:, 1].copy()
            a3[:, 1] = a3[:, 2]
            a3[:, 2] = -y
            return a3

        self.api.import_mesh(
            mesh_name,
            to_akari(verts),
            tris.astype(np.uint32).reshape(nt, 3),
            normals=to_akari(corner_normals),
            uvs=uvs,
            tangents=to_akari(corner_tangents) if corner_tangents is not None else None,
            materials=mat_idx.astype(np.uint32),
        )
        ev.to_mesh_clear()
        self.exported_meshes[mesh_name] = mesh_name
        return mesh_name

    def matrix_to_akari(self, m):
        """Conjugate a Blender world matrix by the Z-up -> Y-up change of basis."""
        B = np.array(
            [[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]], float
        )
        M = np.array([list(r) for r in m])
        return B @ M @ np.linalg.inv(B)

    def export_camera(self, scene):
        cam_obj = scene.camera
        cam = cam_obj.data
        loc = cam_obj.matrix_world.to_translation()
        rot = cam_obj.matrix_world.to_euler("XYZ")
        fov_deg = float(np.degrees(cam.angle))
        self.api.import_camera(
            trs={
                "translation": [loc[0], loc[1], loc[2]],
                "rotation": [rot[0], rot[1], rot[2]],
                "scale": [1.0, 1.0, 1.0],
                "coordinate_system": "Blender",
            },
            fov_deg=fov_deg,
            focal_distance=cam.dof.focus_distance if cam.dof.use_dof else 10.0,
            fstop=cam.dof.aperture_fstop if cam.dof.use_dof else 2.8,
            width=scene.render.resolution_x,
            height=scene.render.resolution_y,
        )

    def export(self):
        scene = bpy.context.scene
        depsgraph = bpy.context.evaluated_depsgraph_get()
        self.export_camera(scene)
        for obj in scene.objects:
            if obj.type != "MESH" or obj.hide_render:
                continue
            mesh = self.export_mesh(obj, depsgraph)
            mats = [self.export_material(m.material) for m in obj.material_slots if m.material]
            if not mats:
                raise RuntimeError(f"object {obj.name} has no material")
            self.api.import_instance(
                obj.name, mesh, self.matrix_to_akari(obj.matrix_world), mats
            )
        path = self.api.write_scene(self.out_dir, compact=True)
        print(f"akari export: wrote {path}")


def main():
    argv = sys.argv[sys.argv.index("--") + 1 :] if "--" in sys.argv else []
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--out", required=True)
    args = ap.parse_args(argv)
    SceneExporter(args.out).export()


if __name__ == "__main__":
    main()
